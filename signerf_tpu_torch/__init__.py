"""PyTorch + CUDA port of `signerf_tpu`, for NVIDIA Hopper (H100).

The JAX package `signerf_tpu` stays the reference; every module here has
its counterpart at the same path there. The port imports `torch` and never
`jax`, `flax` or the JAX package (tests/test_torch_render.py checks this).

Ported so far: the render path (`python -m signerf_tpu_torch.render`),
training of `signerf_nerfacto` and `signerf` (`python -m
signerf_tpu_torch.train ... --train-only True`), the eval CLI, and SDXL +
ControlNet-depth inpainting (`diffusion/`, driven by
`diffusion.diffuser.Diffuser`). The TPU kernels on those paths are
hand-written CUDA kernels under `csrc/`: K1 to K6 (`ops/fused_factor_cuda.py`)
and K7, flash self-attention (`ops/flash_attention.py`), built by
`ops/cuda_build.py`.
"""
