"""Factorized multiresolution (CP) grid encoding, its spatial derivative
and its density MLP.

Port of `signerf_tpu/ops/factor_grid.py`. For level l with resolution R_l
and one line table [R_l, F] per axis, each axis is linearly interpolated at
u * (R_l - 1), the three axes are multiplied, and the levels are
concatenated into D = L * F features; with `include_planes`, three
bilinearly interpolated planes [R_p, R_p, F_p] (xy, xz, yz) add 3 F_p
features (`plane_features`, plain PyTorch: no TPU kernel computes them).
A 2-layer MLP under the flax `Dense(dtype=bfloat16)` contract turns the
features into the field's raw outputs.

Two numeric contracts live here, and the tests hold the port to both JAX
versions:

- `density_mlp_reference` is the JAX package's XLA expression, ported
  as-is: interpolation as a [N, R] "hat" matrix product with the hat
  weights rounded to bf16, bf16 products across the three axes.
- `fused_density_mlp` is the contract of the CUDA kernels
  (`ops/fused_factor_cuda.py`): a two-tap gather per level and axis from
  bf16 tables, f32 tap weights, f32 products, features rounded to bf16 as
  the first MLP operand. It is the Pallas TPU kernel's contract on its
  large levels; the kernel here has no small-level special case, because
  that split existed only for the TPU's lack of a fast gather. Its
  backward (K2) follows the Pallas backward's rounding points and keeps
  the product rule and the line-grad sums in f32. `encode_fused` (K3, K4)
  and `grad_encode_dot` (K5, K6) take the same encode contract without the
  MLP; the derivative of an axis' value is its cell's slope times (R - 1),
  and 0 at an exact knot, as both JAX versions take it. `grad_encode_fused`
  (K8, K9) and `fused_factor_grad` (K8, with a zero VJP) return the
  uncontracted derivative [N, 3, D] under the same contract.
- `cp_level_features` and `plane_features` are the XLA expression of one
  CP level and one plane (the module's `use_fused=False` path);
  `dhat_matrix`, `dfeat01_reference` and `cp_level_features_and_grad` port
  the XLA expression of the spatial derivative (bf16 hat and dhat
  matrices, bf16 products).

Both share the MLP contract (`dense_bf16`): bf16 operands, f32
accumulation, the product rounded to bf16, a bf16 bias add, then ReLU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from signerf_tpu_torch.utils import tracing

Lines = Sequence[Sequence[torch.Tensor]]  # [level][axis] -> [R_l, F]
DenseWeights = Tuple[torch.Tensor, torch.Tensor]  # (kernel [in, out], bias [out])

_BF16 = torch.bfloat16

# Bytes of packed tables `pack_tables` has written in this process (every
# kernel call packs its field's tables anew); `utils/tracing` reads it.
table_pack_bytes = 0


@dataclasses.dataclass(frozen=True)
class FactorGridConfig:
    num_levels: int = 8
    base_res: int = 16
    max_res: int = 1024
    features_per_level: int = 16
    include_planes: bool = False
    plane_res: int = 128
    plane_features: int = 8
    compute_dtype: str = "bfloat16"

    @property
    def resolutions(self) -> Tuple[int, ...]:
        if self.num_levels == 1:
            return (self.base_res,)
        g = math.exp(
            (math.log(self.max_res) - math.log(self.base_res))
            / (self.num_levels - 1)
        )
        return tuple(
            int(round(self.base_res * g**l)) for l in range(self.num_levels)
        )

    @property
    def out_dim(self) -> int:
        d = self.num_levels * self.features_per_level
        if self.include_planes:
            d += 3 * self.plane_features
        return d


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(_BF16).float()


def dense_bf16(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One flax `Dense(dtype=bfloat16)` layer, returned as bf16-valued f32.

    The kernel keeps flax's [in, out] layout (no transpose anywhere). The
    product runs in f32 over bf16-rounded operands, which is exact per term,
    so only the summation order differs from any other f32-accumulating
    implementation; the result is rounded to bf16 before and after the bias.
    """
    h = _round_bf16(_round_bf16(x) @ _round_bf16(kernel))
    return _round_bf16(h + _round_bf16(bias))


def mlp2_reference(feats: torch.Tensor, ws: Sequence[DenseWeights]) -> torch.Tensor:
    """2-layer bf16 MLP (== fields.MLP(num_layers=2)): Dense, ReLU, Dense."""
    (k0, b0), (k1, b1) = ws
    h = torch.relu(dense_bf16(feats, k0, b0))
    return dense_bf16(h, k1, b1)


def hat_matrix(u: torch.Tensor, res: int, dtype: torch.dtype) -> torch.Tensor:
    """[N] coords in [0, 1] -> [N, res] linear-interpolation rows."""
    x = u.clamp(0.0, 1.0) * (res - 1)
    j = torch.arange(res, dtype=x.dtype, device=x.device)
    return (1.0 - (x[:, None] - j[None, :]).abs()).clamp_min(0.0).to(dtype)


def dhat_matrix(u: torch.Tensor, res: int, dtype: torch.dtype) -> torch.Tensor:
    """d hat / du: [N] -> [N, res], -sign(x - j) (R - 1) inside each hat's
    support. At a knot (x = u (R - 1) an integer) every entry is 0."""
    x = u.clamp(0.0, 1.0) * (res - 1)
    j = torch.arange(res, dtype=x.dtype, device=x.device)
    diff = x[:, None] - j[None, :]
    inside = (diff.abs() < 1.0).to(x.dtype)
    return (-torch.sign(diff) * inside * (res - 1)).to(dtype)


def _interp(mat: torch.Tensor, line: torch.Tensor, dtype: torch.dtype = _BF16) -> torch.Tensor:
    """[N, R] @ line with both operands in `dtype` (the hat matrix already
    is), f32 accumulation, the result in `dtype`."""
    return (mat.float() @ line.to(dtype).float()).to(dtype)


def cp_level_features(
    x01: torch.Tensor, lines: Sequence[torch.Tensor], dtype: torch.dtype = _BF16
) -> torch.Tensor:
    """One level under the XLA contract: [N, 3] in [0, 1] -> [N, F] in
    `dtype`. Per axis the hat matrix @ line, both in `dtype` (f32
    accumulation, result in `dtype`), then the product of the three axes
    in `dtype`."""
    res = lines[0].shape[0]
    f = [_interp(hat_matrix(x01[:, ax], res, dtype), lines[ax], dtype) for ax in range(3)]
    return f[0] * f[1] * f[2]


def plane_features(
    x01: torch.Tensor, plane: torch.Tensor, axes: Tuple[int, int], dtype: torch.dtype = _BF16
) -> torch.Tensor:
    """Bilinear interpolation of `plane` [R, R, F] spanning `axes` under the
    XLA contract -> [N, F] in `dtype`: the plane contracted with the first
    axis's hat matrix ([N, R] @ [R, R F], f32 accumulation, result in
    `dtype`), then reduced row by row with the second's."""
    r, _, f = plane.shape
    ha = hat_matrix(x01[:, axes[0]], r, dtype)
    hb = hat_matrix(x01[:, axes[1]], r, dtype)
    t1 = _interp(ha, plane.reshape(r, r * f), dtype).reshape(-1, r, f)
    return (hb.float()[:, None, :] @ t1.float()).squeeze(1).to(dtype)


def cp_level_features_and_grad(
    x01: torch.Tensor, lines: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level under the XLA contract, with its spatial derivative:
    (feat [N, F], d feat / d pos01 [N, 3, F]), both bf16. Per axis the
    value is bf16 hat @ line and the slope bf16 dhat @ line; the products
    are bf16, left to right, as the JAX expression takes them."""
    res = lines[0].shape[0]
    f = [_interp(hat_matrix(x01[:, ax], res, _BF16), lines[ax]) for ax in range(3)]
    d = [_interp(dhat_matrix(x01[:, ax], res, _BF16), lines[ax]) for ax in range(3)]
    grad = torch.stack([d[0] * f[1] * f[2], f[0] * d[1] * f[2], f[0] * f[1] * d[2]], dim=-2)
    return f[0] * f[1] * f[2], grad


def dfeat01_reference(cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA expression for d feat / d pos01: [N, 3, D] f32."""
    grads = [cp_level_features_and_grad(x01, lines[lvl])[1] for lvl in range(len(cfg.resolutions))]
    return torch.cat(grads, dim=-1).float()


def _encode_reference(cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor) -> torch.Tensor:
    """Hat-matrix CP encode over a [level][axis] line list -> [N, D] f32."""
    feats = [
        cp_level_features(x01, lines[lvl]) for lvl in range(len(cfg.resolutions))
    ]
    return torch.cat(feats, dim=-1).float()


def density_mlp_reference(
    cfg: FactorGridConfig, lines: Lines, ws: Sequence[DenseWeights], x01: torch.Tensor
) -> torch.Tensor:
    """The JAX package's XLA encode + MLP expression: [N, O] f32."""
    return mlp2_reference(_encode_reference(cfg, lines, x01), ws)


def pack_tables(lines: Lines) -> torch.Tensor:
    """The [level][axis] line tables as one flat contiguous bf16 buffer, in
    level-major, then axis, then row order: the layout the kernel reads."""
    global table_pack_bytes
    packed = torch.cat([t.reshape(-1) for axes in lines for t in axes]).to(_BF16)
    table_pack_bytes += packed.numel() * packed.element_size()
    return packed


def _kernel(name: str, device: torch.device):
    """`fused_factor_cuda.<name>_cuda` (the CUDA kernel) for a CUDA tensor,
    `<name>_plain` (its plain twin) for a CPU tensor. Nothing falls back
    from one to the other."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    if device.type == "cuda":
        return getattr(ffc, f"{name}_cuda")
    if device.type == "cpu":
        return getattr(ffc, f"{name}_plain")
    raise RuntimeError(f"{name}: no kernel for device {device}")


def _nested(cfg: FactorGridConfig, lines: Sequence[torch.Tensor]):
    return [lines[3 * lvl : 3 * lvl + 3] for lvl in range(len(cfg.resolutions))]


def _unpack(g_tables: torch.Tensor, lines: Sequence[torch.Tensor]):
    """A packed f32 line-grad buffer -> one view per line, in `lines` order."""
    g_lines, offset = [], 0
    for line in lines:
        g_lines.append(g_tables[offset : offset + line.numel()].view(line.shape))
        offset += line.numel()
    return g_lines


class _FusedDensityMLP(torch.autograd.Function):
    """The counterpart of the JAX `custom_vjp` of `fused_density_mlp`.

    Takes the f32 line tables and Dense params (so autograd hands back f32
    grads) and packs and rounds them to bf16 inside. Saves only its inputs:
    the backward recomputes the features, as K2 does."""

    @staticmethod
    def forward(ctx, cfg, x01, k0, b0, k1, b1, *lines):
        with tracing.span("ops.k1"):
            ctx.cfg = cfg
            ctx.save_for_backward(x01, k0, b0, k1, *lines)
            fwd = _kernel("density_mlp", x01.device)
            return fwd(
                cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)),
                k0.to(_BF16), b0.to(_BF16), k1.to(_BF16), b1.to(_BF16), x01.detach(),
            )

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x01, k0, b0, k1, *lines = ctx.saved_tensors
        want_x = ctx.needs_input_grad[1]
        want_tables = any(ctx.needs_input_grad[2:])
        bwd = _kernel("density_mlp_bwd", x01.device)
        g_tables, g_ws, g_x = bwd(
            cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)),
            k0.to(_BF16), b0.to(_BF16), k1.to(_BF16), x01, g.float().contiguous(),
            tables_half=want_tables, coords_half=want_x,
        )
        if g_tables is None:
            return (None, g_x, None, None, None, None, *([None] * len(lines)))
        return (None, g_x, *g_ws, *_unpack(g_tables, lines))


def fused_density_mlp(
    cfg: FactorGridConfig, lines: Lines, ws: Sequence[DenseWeights], x01: torch.Tensor
) -> torch.Tensor:
    """Encode + 2-layer MLP in one pass: [N, 3] pos01 in [0, 1] -> [N, O] f32.

    Differentiable in the line tables, the Dense params and x01. A CUDA
    tensor goes to the hand-written kernels (K1 forward, K2 backward), which
    raise for what they do not take; a CPU tensor goes to their plain
    PyTorch twins.
    """
    (k0, b0), (k1, b1) = ws
    flat = [t for axes in lines for t in axes]
    return _FusedDensityMLP.apply(cfg, x01, k0, b0, k1, b1, *flat)


class _EncodeFused(torch.autograd.Function):
    """The counterpart of the JAX `custom_vjp` `_encode_fused`: K3 forward,
    K4 backward. Takes the f32 line tables and packs and rounds them to
    bf16 inside; saves only its inputs."""

    @staticmethod
    def forward(ctx, cfg, x01, *lines):
        ctx.cfg = cfg
        ctx.save_for_backward(x01, *lines)
        fwd = _kernel("encode", x01.device)
        return fwd(cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01.detach())

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x01, *lines = ctx.saved_tensors
        want_tables = any(ctx.needs_input_grad[2:])
        bwd = _kernel("encode_bwd", x01.device)
        g_tables, g_x = bwd(
            cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01,
            g.float().contiguous(), tables_half=want_tables, coords_half=ctx.needs_input_grad[1],
        )
        g_lines = [None] * len(lines) if g_tables is None else _unpack(g_tables, lines)
        return (None, g_x, *g_lines)


def encode_fused(cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor) -> torch.Tensor:
    """CP encode: [N, 3] pos01 in [0, 1] -> [N, D] f32 features under the
    kernels' contract (two-tap gathers from bf16 tables, f32 tap weights
    and products). Differentiable in the line tables and x01: K3 and K4 on
    a CUDA tensor, their plain twins on a CPU tensor."""
    return _EncodeFused.apply(cfg, x01, *[t for axes in lines for t in axes])


class _GradEncodeDot(torch.autograd.Function):
    """The counterpart of the JAX `custom_vjp` `grad_encode_dot`: K5
    forward, K6 backward. K6's tables launch hands back the line grads and
    grad_g together; its coords launch runs only when x01 needs a grad."""

    @staticmethod
    def forward(ctx, cfg, x01, g, *lines):
        ctx.cfg = cfg
        ctx.save_for_backward(x01, g, *lines)
        fwd = _kernel("grad_dot", x01.device)
        return fwd(
            cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01.detach(),
            g.detach().float().contiguous(),
        )

    @staticmethod
    def backward(ctx, ct):
        cfg = ctx.cfg
        x01, g, *lines = ctx.saved_tensors
        want_tables = any(ctx.needs_input_grad[2:])
        bwd = _kernel("grad_dot_bwd", x01.device)
        g_tables, g_g, g_x = bwd(
            cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01,
            g.float().contiguous(), ct.float().contiguous(), tables_half=want_tables,
            coords_half=ctx.needs_input_grad[1],
        )
        g_lines = [None] * len(lines) if g_tables is None else _unpack(g_tables, lines)
        return (None, g_x, g_g, *g_lines)


def grad_encode_dot(
    cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """s[n, a] = sum_d d feat[n, d] / d pos01[n, a] * g[n, d] -> [N, 3] f32,
    the encode's spatial derivative contracted with g [N, D] (the density
    channel's VJP row through the base MLP), under the kernels' contract.
    The slope is 0 at an exact knot, as both JAX versions take it.
    Differentiable in the line tables, x01 and g: K5 and K6 on a CUDA
    tensor, their plain twins on a CPU tensor."""
    return _GradEncodeDot.apply(cfg, x01, g, *[t for axes in lines for t in axes])


class _GradEncodeFused(torch.autograd.Function):
    """The counterpart of the JAX `custom_vjp` `grad_encode_fused`: K8
    forward, K9 backward. K9's coords launch runs only when x01 needs a
    grad."""

    @staticmethod
    def forward(ctx, cfg, x01, *lines):
        ctx.cfg = cfg
        ctx.save_for_backward(x01, *lines)
        fwd = _kernel("grad", x01.device)
        return fwd(cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01.detach())

    @staticmethod
    def backward(ctx, ct):
        cfg = ctx.cfg
        x01, *lines = ctx.saved_tensors
        bwd = _kernel("grad_bwd", x01.device)
        g_tables, g_x = bwd(
            cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01,
            ct.float().contiguous(), tables_half=any(ctx.needs_input_grad[2:]),
            coords_half=ctx.needs_input_grad[1],
        )
        g_lines = [None] * len(lines) if g_tables is None else _unpack(g_tables, lines)
        return (None, g_x, *g_lines)


def grad_encode_fused(cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor) -> torch.Tensor:
    """d feat / d pos01 -> [N, 3, D] f32 under the kernels' contract (the
    slope is 0 at an exact knot), differentiable in the line tables and
    x01: K8 and K9 on a CUDA tensor, their plain twins on a CPU tensor.
    The counterpart of `signerf_tpu/ops/factor_grid.py` `grad_encode_fused`."""
    return _GradEncodeFused.apply(cfg, x01, *[t for axes in lines for t in axes])


class _FusedFactorGrad(torch.autograd.Function):
    """K8 with a zero VJP, as `fused_factor_grad_tpu`'s custom_vjp: the
    output takes part in autograd, and the tables and coordinates get zero
    gradients (not None)."""

    @staticmethod
    def forward(ctx, cfg, x01, *lines):
        ctx.inputs = [(t.shape, t.dtype, t.device) for t in (x01, *lines)]
        fwd = _kernel("grad", x01.device)
        return fwd(cfg.resolutions, cfg.features_per_level, pack_tables(_nested(cfg, lines)), x01.detach())

    @staticmethod
    def backward(ctx, ct):
        zeros = [
            torch.zeros(shape, dtype=dtype, device=device) if need else None
            for (shape, dtype, device), need in zip(ctx.inputs, ctx.needs_input_grad[1:])
        ]
        return (None, *zeros)


def fused_factor_grad(cfg: FactorGridConfig, lines: Lines, x01: torch.Tensor) -> torch.Tensor:
    """d feat / d pos01 -> [N, 3, D] f32 through K8 (its plain twin on a CPU
    tensor), DETACHED by a zero VJP: the counterpart of
    `ffp.fused_factor_grad_tpu` (gradient normals as a supervision target).
    Unlike `.detach()`, the output still requires grad when its inputs do,
    and a backward through it hands the tables and x01 zeros."""
    return _FusedFactorGrad.apply(cfg, x01, *[t for axes in lines for t in axes])
