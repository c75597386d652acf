"""PyTorch + CUDA port of `signerf_tpu`, for NVIDIA Hopper (H100).

The JAX package `signerf_tpu` stays the reference; every module here has
its counterpart at the same path there. The port imports `torch` and never
`jax`, `flax` or the JAX package (tests/test_torch_render.py checks this).

Ported so far: the render path (`python -m signerf_tpu_torch.render`), with
the factor-grid encode + density MLP as a hand-written CUDA kernel
(`ops/fused_factor_cuda.py`, `csrc/fused_factor_density.cu`).
"""
