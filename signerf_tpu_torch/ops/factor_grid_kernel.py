"""The early dense-hat factor-grid encode (K10) and its VJP.

The counterpart of `signerf_tpu/ops/pallas/factor_grid_kernel.py`
`factor_encode_pallas(x01, lines_tuple, resolutions)`: per level l and
axis a, hat = relu(1 - |u (R_l - 1) - j|) rounded to bf16, times the bf16
line table with f32 accumulation, the three axes multiplied in f32, the
levels concatenated into [N, L F] f32.

The forward is K10 (`csrc/fused_factor_encode.cu`) on a CUDA tensor and
its plain twin on a CPU tensor. A hat row has two nonzero entries, so the
kernel gathers two rows per level and axis and never forms the [N, R] hat
matrix (at N = 196,608 and R = 2048 that would be 0.8 GB per level and
axis).

The backward is the VJP of the JAX package's `_forward_ref`, the function
`factor_encode_pallas`'s custom VJP differentiates, taken as K4 (the two
launches of `fused_factor_encode_bwd_tpu`'s port) on a CUDA tensor and as
K4's twin on a CPU tensor. It differs from `jax.vjp` of `_forward_ref` in
two places: `_forward_ref` rounds each axis' value to bf16 before the
product, K4 keeps the f32 values of K1's taps; and at an exact knot
(u (R - 1) an integer) the coordinate slope is 0 here, where XLA's autodiff
of relu and |.| takes half of each neighbouring cell's slope.
"""

from __future__ import annotations

from typing import Sequence

import torch

from signerf_tpu_torch.ops.factor_grid import _kernel, _unpack, pack_tables


class _FactorEncodeKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, resolutions, x01, *lines):
        ctx.resolutions = resolutions
        ctx.save_for_backward(x01, *lines)
        fwd = _kernel("dense_encode", x01.device)
        return fwd(resolutions, lines[0].shape[-1], pack_tables([lines]), x01.detach())

    @staticmethod
    def backward(ctx, g):
        x01, *lines = ctx.saved_tensors
        bwd = _kernel("encode_bwd", x01.device)
        g_tables, g_x = bwd(
            ctx.resolutions, lines[0].shape[-1], pack_tables([lines]), x01, g.float().contiguous(),
            tables_half=any(ctx.needs_input_grad[2:]), coords_half=ctx.needs_input_grad[1],
        )
        g_lines = [None] * len(lines) if g_tables is None else _unpack(g_tables, lines)
        return (None, g_x, *g_lines)


def factor_encode_kernel(
    x01: torch.Tensor, lines_tuple: Sequence[torch.Tensor], resolutions: Sequence[int]
) -> torch.Tensor:
    """[N, 3] pos01 in [0, 1] -> [N, L F] f32 features; `lines_tuple` is the
    flat level-major tuple of L * 3 tables [R_l, F]. Differentiable in the
    tables and x01."""
    resolutions = tuple(int(r) for r in resolutions)
    lines = tuple(lines_tuple)
    if len(lines) != 3 * len(resolutions):
        raise ValueError(f"{len(lines)} line tables for {len(resolutions)} levels; expected 3 per level")
    feat = lines[0].shape[-1]
    for i, t in enumerate(lines):
        if tuple(t.shape) != (resolutions[i // 3], feat):
            raise ValueError(f"line {i} has shape {tuple(t.shape)}, expected {(resolutions[i // 3], feat)}")
    return _FactorEncodeKernel.apply(resolutions, x01, *lines)
