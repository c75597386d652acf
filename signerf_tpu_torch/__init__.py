"""PyTorch + CUDA port of `signerf_tpu`, for NVIDIA Hopper (H100).

The JAX package `signerf_tpu` stays the reference; every module here has
its counterpart at the same path there. The port imports `torch` and never
`jax`, `flax` or the JAX package (tests/test_torch_render.py checks this).

Ported so far: the render path (`python -m signerf_tpu_torch.render`),
training of `signerf_nerfacto` and `signerf` (`python -m
signerf_tpu_torch.train ... --train-only True`), the eval CLI, and SDXL +
ControlNet-depth inpainting (`diffusion/`, driven by
`diffusion.diffuser.Diffuser`), and the editing geometry that builds the
reference sheet (`editing/`, `geometry/`). Every TPU kernel of the JAX
package is a hand-written CUDA kernel under `csrc/`: K1 to K6 and K8 to
K10 (`ops/fused_factor_cuda.py`; K8 to K10 behind
`ops/factor_grid.grad_encode_fused`, `fused_factor_grad` and
`ops/factor_grid_kernel.factor_encode_kernel`) and K7, flash
self-attention (`ops/flash_attention.py`), built by `ops/cuda_build.py`.
"""
