"""K1 to K6 and K8 to K10: the factor-grid kernels, hand-written in CUDA.

The Pallas TPU kernels of `signerf_tpu/ops/fused_factor_pallas.py` that
they replace:

- K1 `fused_factor_density_tpu` and K2 `fused_factor_density_bwd_tpu`: the
  encode + density MLP and its backward (the proposal fields, and the base
  field without normals), in `csrc/fused_factor_density.cu` and
  `csrc/fused_factor_density_bwd.cu`;
- K3 `fused_factor_encode_tpu` and K4 `fused_factor_encode_bwd_tpu`: the
  encode alone and its backward (the base field with gradient normals), in
  `csrc/fused_factor_encode.cu`;
- K5 `fused_factor_grad_dot_tpu` and K6 `fused_factor_grad_dot_bwd_tpu`: the
  encode's spatial derivative contracted with the density's feature
  cotangent, and its backward (the gradient normals), in
  `csrc/fused_factor_grad_dot.cu`;
- K8 `fused_factor_grad_tpu` and K9 `fused_factor_grad_bwd_tpu`: the
  encode's uncontracted spatial derivative [N, 3, D] and its backward
  (`factor_grid.grad_encode_fused`, `factor_grid.fused_factor_grad`), in
  `csrc/fused_factor_grad.cu`;
- K10 `factor_encode_pallas` of `signerf_tpu/ops/pallas/factor_grid_kernel.py`:
  the early dense-hat encode (`factor_grid_kernel.factor_encode_kernel`),
  in `csrc/fused_factor_encode.cu` beside K3; its backward is K4.

Each source's header says what it computes, what bounds it on an H100 and
what the design does about it. In short, K1, K3 and K10 gather a tile of
128 samples' features into shared memory in persistent blocks (one shared
encode routine, `factor_grid::encode_tile`); K1 runs its MLP on the tensor
cores from there, K3 and K10 write the tile with one bulk copy. K2
recomputes K1's features per sample (bit for bit: the same rounded lerps),
takes the MLP VJP at the Pallas kernel's bf16 rounding points with
the MLP products on the tensor cores, keeps dW/db per block and flushes
them once per block, and sums the line grads over runs of lanes on the
same row before adding them into device memory with vector reductions (so
its sums are reproducible to f32 rounding, not bitwise). K5 walks K3's
tiles and parts, with each tile's g brought into shared memory by one bulk
copy. K8 and the coords halves of K4, K6 and K9 run one thread per
(sample, level). The tables halves of K4, K6 and K9 take K2's scatter: one
thread per sample with the levels in a loop, the line grads summed over
runs of lanes on one row and added with vector reductions into L2, no
shared-memory atomics. All keep K1's taps and f32 contract. K5, K6, K8,
K9 and the coords half of K4 take the derivative of an axis' value as 0 at
an exact knot, as both JAX versions do (K2's coords half takes the slope
of the cell K1 reads there).

The TPU kernels' dense-hat block GEMM, 9-row one-hot GEMM, transposed
[D, N] layout and packed small/large grad layout existed only because the
TPU has no fast gather or scatter; the port keeps the function, not that
schedule: each level and axis is a two-row gather (K1) or a two-row scatter
(K2), and the line grads come back as one f32 buffer in `pack_tables` order.

Build: `cuda_build.library` compiles every source of the port (these and
K7's) into its own library under `build/kernels/`, all compilers started
together, and loads them with ctypes (plain C interface).

Every kernel `<name>_cuda` has a plain PyTorch twin `<name>_plain` on the
same packed inputs and with the same returns. `factor_grid`'s autograd
Functions take the twins for CPU tensors; the tests and `chip_smoke.py`
hold the kernels against them on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from signerf_tpu_torch.ops.cuda_build import library
from signerf_tpu_torch.ops.factor_grid import dense_bf16, mlp2_reference

# (features_per_level, hidden, out, levels) K1 and K2 are instantiated for:
# the proposal fields and the base field of `signerf_nerfacto`.
SUPPORTED = {(8, 16, 1, 5), (16, 64, 16, 8)}
# (features_per_level, levels) K3, K5, K6, K8 and K9 are instantiated for:
# the base field.
ENCODE_SUPPORTED = {(16, 8)}
# ... and K10 and K4 (K10's backward): the base and the proposal fields.
DENSE_SUPPORTED = {(16, 8), (8, 5)}

# Launches in this process; only the wrappers below add to them, once per
# launch. `chip_smoke.py` resets and reads them.
launches = 0  # K1
bwd_table_launches = 0  # K2, line grads and dW/db
bwd_coords_launches = 0  # K2, coordinate grads
encode_launches = 0  # K3
encode_bwd_table_launches = 0  # K4, line grads
encode_bwd_coords_launches = 0  # K4, coordinate grads
grad_dot_launches = 0  # K5
grad_dot_bwd_table_launches = 0  # K6, line grads and grad_g
grad_dot_bwd_coords_launches = 0  # K6, coordinate grads
grad_launches = 0  # K8
grad_bwd_table_launches = 0  # K9, line grads
grad_bwd_coords_launches = 0  # K9, coordinate grads
dense_encode_launches = 0  # K10
COUNTERS = (
    "launches", "bwd_table_launches", "bwd_coords_launches",
    "encode_launches", "encode_bwd_table_launches", "encode_bwd_coords_launches",
    "grad_dot_launches", "grad_dot_bwd_table_launches", "grad_dot_bwd_coords_launches",
    "grad_launches", "grad_bwd_table_launches", "grad_bwd_coords_launches", "dense_encode_launches",
)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad; call the kernel on detached tensors")


def _check_common(resolutions, feat, tables, w0, b0, w1, x01):
    """Device, shape and type checks shared by K1 and K2 -> (n, hidden, out)."""
    device = x01.device
    if device.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {device}")
    n = x01.shape[0]
    levels = len(resolutions)
    hidden, out_dim = w1.shape if w1.dim() == 2 else (-1, -1)
    if (feat, hidden, out_dim, levels) not in SUPPORTED:
        raise ValueError(
            f"no kernel for features_per_level={feat}, hidden={hidden}, out={out_dim}, "
            f"levels={levels}; instantiated for {sorted(SUPPORTED)}"
        )
    bf16 = torch.bfloat16
    _check("x01", x01, torch.float32, (n, 3), device)
    _check("tables", tables, bf16, (3 * sum(resolutions) * feat,), device)
    _check("w0", w0, bf16, (levels * feat, hidden), device)
    _check("b0", b0, bf16, (hidden,), device)
    _check("w1", w1, bf16, (hidden, out_dim), device)
    if tables.data_ptr() % 16:
        raise ValueError("tables must be 16-byte aligned for the vector loads")
    if n >= 2**31:
        raise ValueError(f"N={n} does not fit the kernel's int count")
    return n, hidden, out_dim


def _launch(lib_name: str, fn_name: str, device, *args) -> None:
    """Call `fn_name` of library `lib_name` on the current stream of
    `device`; raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(library(lib_name), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {rc}")


def density_mlp_cuda(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    x01: torch.Tensor,
) -> torch.Tensor:
    """Launch K1 on x01's stream: [N, 3] f32 in [0, 1] -> [N, O] f32.

    `tables` is `factor_grid.pack_tables` output; w0 [D, H], b0 [H], w1 [H, O]
    and b1 [O] are bf16 in flax layout. Raises for anything the kernel does
    not take, and when the launch fails.
    """
    global launches
    n, hidden, out_dim = _check_common(resolutions, feat, tables, w0, b0, w1, x01)
    _check("b1", b1, torch.bfloat16, (out_dim,), x01.device)
    if w0.data_ptr() % 16 or w1.data_ptr() % 16:
        raise ValueError("w0 and w1 must be 16-byte aligned for the kernel's weight copies")
    out = torch.empty((n, out_dim), dtype=torch.float32, device=x01.device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    _launch("fused_factor_density", "fused_factor_density_forward", x01.device,
            x01.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat, hidden, out_dim,
            w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr())
    launches += 1
    return out


BwdResult = Tuple[
    Optional[torch.Tensor],
    Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    Optional[torch.Tensor],
]


def density_mlp_bwd_cuda(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> BwdResult:
    """Launch K2 on x01's stream, given the cotangent g [N, O] f32 of K1's
    output on the same inputs (b1 does not enter the backward).

    Returns (line grads as one packed f32 buffer in `pack_tables` order,
    (dW0 [D, H], db0 [H], dW1 [H, O], db1 [O]) f32, coords grad [N, 3] f32);
    the tables/MLP half fills the first two and the coords half the last,
    each only when asked for (None otherwise), one launch each.
    """
    global bwd_table_launches, bwd_coords_launches
    n, hidden, out_dim = _check_common(resolutions, feat, tables, w0, b0, w1, x01)
    device = x01.device
    _check("g", g, torch.float32, (n, out_dim), device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    f32 = dict(dtype=torch.float32, device=device)
    g_tables = g_ws = g_coords = None
    common = (
        x01.data_ptr(), g.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat,
        hidden, out_dim, w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
    )
    if tables_half:
        g_tables = torch.zeros(tables.numel(), **f32)
        g_ws = (
            torch.zeros(tuple(w0.shape), **f32),
            torch.zeros(hidden, **f32),
            torch.zeros(hidden, out_dim, **f32),
            torch.zeros(out_dim, **f32),
        )
        _launch("fused_factor_density_bwd", "fused_factor_density_backward", device,
                *common, g_tables.data_ptr(), *(t.data_ptr() for t in g_ws), None, 0)
        bwd_table_launches += 1
    if coords_half:
        g_coords = torch.empty((n, 3), **f32)
        _launch("fused_factor_density_bwd", "fused_factor_density_backward", device,
                *common, None, None, None, None, None, g_coords.data_ptr(), 1)
        bwd_coords_launches += 1
    return g_tables, g_ws, g_coords


def density_mlp_bwd_occupancy(
    resolutions: Sequence[int], feat: int, hidden: int, out_dim: int, tables_half: bool = True, device=None
) -> Tuple[int, int]:
    """(dynamic shared memory in bytes, blocks an SM holds) of K2's tables
    (or coords) kernel for this field on `device` (default: the current
    card), for reports; launches nothing."""
    levels = len(resolutions)
    if (feat, hidden, out_dim, levels) not in SUPPORTED:
        raise ValueError(f"no kernel for features_per_level={feat}, hidden={hidden}, out={out_dim}, levels={levels}")
    res = (ctypes.c_int * levels)(*resolutions)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = library("fused_factor_density_bwd").fused_factor_density_backward_occupancy(
            res, levels, feat, hidden, out_dim, 0 if tables_half else 1, ctypes.byref(smem), ctypes.byref(blocks)
        )
    if rc != 0:
        raise RuntimeError(f"fused_factor_density_backward_occupancy failed with CUDA error {rc}")
    return smem.value, blocks.value


def _check_encode(resolutions, feat, tables, x01, g=None, supported=ENCODE_SUPPORTED, g_shape=None) -> int:
    """Device, shape and type checks shared by K3 to K6 and K8 to K10 -> N.
    g is the [N, L F] (or `g_shape`) f32 cotangent or input, when there is one."""
    device = x01.device
    if device.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {device}")
    levels = len(resolutions)
    if (feat, levels) not in supported:
        raise ValueError(
            f"no kernel for features_per_level={feat}, levels={levels}; "
            f"instantiated for {sorted(supported)}"
        )
    n = x01.shape[0]
    _check("x01", x01, torch.float32, (n, 3), device)
    _check("tables", tables, torch.bfloat16, (3 * sum(resolutions) * feat,), device)
    if g is not None:
        _check("g", g, torch.float32, g_shape or (n, levels * feat), device)
    if tables.data_ptr() % 16 or (g is not None and g.data_ptr() % 16):
        raise ValueError("tables and g must be 16-byte aligned for the vector loads")
    if n * levels >= 2**31:
        raise ValueError(f"N={n} x {levels} levels does not fit the kernel's int count")
    return n


def encode_cuda(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """Launch K3 on x01's stream: [N, 3] f32 in [0, 1] -> feat [N, L F] f32."""
    global encode_launches
    n = _check_encode(resolutions, feat, tables, x01)
    out = torch.empty((n, len(resolutions) * feat), dtype=torch.float32, device=x01.device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    _launch("fused_factor_encode", "fused_factor_encode_forward", x01.device,
            x01.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat, out.data_ptr())
    encode_launches += 1
    return out


def encode_bwd_cuda(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K4 on x01's stream, given the cotangent g [N, L F] f32 of K3's
    (or K10's) output. Returns (line grads as one packed f32 buffer in
    `pack_tables` order, coords grad [N, 3] f32), each only when asked for
    (None otherwise), one launch each."""
    global encode_bwd_table_launches, encode_bwd_coords_launches
    n = _check_encode(resolutions, feat, tables, x01, g, DENSE_SUPPORTED)
    device = x01.device
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    common = (x01.data_ptr(), g.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat)
    g_tables = g_coords = None
    if tables_half:
        # torch.zeros is 16-byte aligned, as the float4 reductions into its rows need
        g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=device)
        _launch("fused_factor_encode", "fused_factor_encode_backward", device,
                *common, g_tables.data_ptr(), None, 0)
        encode_bwd_table_launches += 1
    if coords_half:  # zeroed: levels that do not tile a warp add atomically
        g_coords = torch.zeros((n, 3), dtype=torch.float32, device=device)
        _launch("fused_factor_encode", "fused_factor_encode_backward", device,
                *common, None, g_coords.data_ptr(), 1)
        encode_bwd_coords_launches += 1
    return g_tables, g_coords


def grad_dot_cuda(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Launch K5 on x01's stream: s[n, a] = <d feat[n] / d u_a, g[n]> -> [N, 3] f32."""
    global grad_dot_launches
    n = _check_encode(resolutions, feat, tables, x01, g)
    out = torch.empty((n, 3), dtype=torch.float32, device=x01.device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    _launch("fused_factor_grad_dot", "fused_factor_grad_dot_forward", x01.device,
            x01.data_ptr(), g.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat,
            out.data_ptr())
    grad_dot_launches += 1
    return out


def grad_dot_bwd_cuda(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    ct: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K6 on x01's stream, given the cotangent ct [N, 3] f32 of K5's
    output. Returns (line grads as one packed f32 buffer, grad_g [N, L F],
    coords grad [N, 3]); the tables half fills the first two and the coords
    half the last, each only when asked for (None otherwise), one launch
    each."""
    global grad_dot_bwd_table_launches, grad_dot_bwd_coords_launches
    n = _check_encode(resolutions, feat, tables, x01, g)
    device = x01.device
    _check("ct", ct, torch.float32, (n, 3), device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    common = (x01.data_ptr(), g.data_ptr(), ct.data_ptr(), n, tables.data_ptr(), res,
              len(resolutions), feat)
    g_tables = g_g = g_coords = None
    if tables_half:
        # torch.zeros is 16-byte aligned, as the float4 reductions into its rows need
        g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=device)
        g_g = torch.empty_like(g)
        _launch("fused_factor_grad_dot", "fused_factor_grad_dot_backward", device,
                *common, g_tables.data_ptr(), g_g.data_ptr(), None, 0)
        grad_dot_bwd_table_launches += 1
    if coords_half:
        g_coords = torch.empty((n, 3), dtype=torch.float32, device=device)
        _launch("fused_factor_grad_dot", "fused_factor_grad_dot_backward", device,
                *common, None, None, g_coords.data_ptr(), 1)
        grad_dot_bwd_coords_launches += 1
    return g_tables, g_g, g_coords


def grad_cuda(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """Launch K8 on x01's stream: out[n, a] = d feat[n] / d u_a -> [N, 3, L F] f32."""
    global grad_launches
    n = _check_encode(resolutions, feat, tables, x01)
    out = torch.empty((n, 3, len(resolutions) * feat), dtype=torch.float32, device=x01.device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    _launch("fused_factor_grad", "fused_factor_grad_forward", x01.device,
            x01.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat, out.data_ptr())
    grad_launches += 1
    return out


def grad_bwd_cuda(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    ct: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K9 on x01's stream, given the cotangent ct [N, 3, L F] f32 of
    K8's output. Returns (line grads as one packed f32 buffer in
    `pack_tables` order, coords grad [N, 3] f32), each only when asked for
    (None otherwise), one launch each."""
    global grad_bwd_table_launches, grad_bwd_coords_launches
    n = _check_encode(resolutions, feat, tables, x01, ct, g_shape=(x01.shape[0], 3, len(resolutions) * feat))
    device = x01.device
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    common = (x01.data_ptr(), ct.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat)
    g_tables = g_coords = None
    if tables_half:
        g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=device)
        _launch("fused_factor_grad", "fused_factor_grad_backward", device, *common, g_tables.data_ptr(), None, 0)
        grad_bwd_table_launches += 1
    if coords_half:
        g_coords = torch.empty((n, 3), dtype=torch.float32, device=device)
        _launch("fused_factor_grad", "fused_factor_grad_backward", device, *common, None, g_coords.data_ptr(), 1)
        grad_bwd_coords_launches += 1
    return g_tables, g_coords


def dense_encode_cuda(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """Launch K10 on x01's stream: [N, 3] f32 in [0, 1] -> feat [N, L F] f32
    under the dense-hat contract (bf16 hat weights)."""
    global dense_encode_launches
    n = _check_encode(resolutions, feat, tables, x01, supported=DENSE_SUPPORTED)
    out = torch.empty((n, len(resolutions) * feat), dtype=torch.float32, device=x01.device)
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    _launch("fused_factor_encode", "factor_dense_encode_forward", x01.device,
            x01.data_ptr(), n, tables.data_ptr(), res, len(resolutions), feat, out.data_ptr())
    dense_encode_launches += 1
    return out


def _taps(u: torch.Tensor, res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's two taps of one level and axis: row i (clamped to R - 2, so
    u = 1 reads the last row with w = 1) and weight w [N, 1]."""
    x = u * (res - 1)
    i = x.floor().clamp(0, res - 2)
    return i.long(), (x - i)[:, None]


def density_mlp_plain(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    x01: torch.Tensor,
) -> torch.Tensor:
    """K1's contract in plain PyTorch, on the same inputs: K3's encode, then
    the bf16 MLP."""
    return mlp2_reference(encode_plain(resolutions, feat, tables, x01), ((w0, b0), (w1, b1)))


def density_mlp_bwd_plain(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> BwdResult:
    """K2's contract in plain PyTorch, on the same inputs and with the same
    returns as `density_mlp_bwd_cuda`."""
    u = x01.clamp(0.0, 1.0)
    tab = tables.float()
    levels, feats, offset = [], [], 0
    for res in resolutions:
        axes, prod = [], None
        for ax in range(3):
            line = tab[offset : offset + res * feat].view(res, feat)
            i, w = _taps(u[:, ax], res)
            r0, r1 = line[i], line[i + 1]
            f = (1.0 - w) * r0 + w * r1
            axes.append((offset, res, i, w, f, r1 - r0))
            prod = f if prod is None else prod * f
            offset += res * feat
        levels.append(axes)
        feats.append(prod)
    rb = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    feats_b = rb(torch.cat(feats, dim=-1))
    w0f, w1f = w0.float(), w1.float()
    h = torch.relu(dense_bf16(feats_b, w0, b0))
    g_o = rb(g)
    g_h = (g_o @ w1f.T) * (h > 0)
    g_h_b = rb(g_h)
    g_feat = rb(g_h_b @ w0f.T)  # [N, D]

    g_tables = g_ws = g_coords = None
    if tables_half:
        g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=tables.device)
        g_ws = (feats_b.T @ g_h_b, g_h.sum(0), h.T @ g_o, g_o.sum(0))
    if coords_half:
        g_coords = torch.zeros_like(u)
    for lvl, axes in enumerate(levels):
        g_l = g_feat[:, lvl * feat : (lvl + 1) * feat]
        for ax, (off, res, i, w, _, diff) in enumerate(axes):
            G = g_l * axes[(ax + 1) % 3][4] * axes[(ax + 2) % 3][4]
            if tables_half:
                grad = g_tables[off : off + res * feat].view(res, feat)
                grad.index_add_(0, i, (1.0 - w) * G)
                grad.index_add_(0, i + 1, w * G)
            if coords_half:
                g_coords[:, ax] += (G * diff).sum(-1) * (res - 1)
    return g_tables, g_ws, g_coords


@dataclasses.dataclass
class _Axis:
    """One level and axis of every sample under K1's taps: the table's
    offset and resolution, row i, weight w and slope factor s [N, 1] (0 at
    an exact knot, R - 1 elsewhere), value f and slope d [N, F]."""

    offset: int
    res: int
    i: torch.Tensor
    w: torch.Tensor
    s: torch.Tensor
    f: torch.Tensor
    d: torch.Tensor


def _axes(resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor):
    """[level][axis] -> _Axis, in f32 from the bf16 tables."""
    u = x01.clamp(0.0, 1.0)
    tab = tables.float()
    levels, offset = [], 0
    for res in resolutions:
        axes = []
        for ax in range(3):
            line = tab[offset : offset + res * feat].view(res, feat)
            i, w = _taps(u[:, ax], res)
            r0, r1 = line[i], line[i + 1]
            s = torch.where((w == 0.0) | (w == 1.0), 0.0, float(res - 1))
            axes.append(_Axis(offset, res, i, w, s, (1.0 - w) * r0 + w * r1, (r1 - r0) * s))
            offset += res * feat
        levels.append(axes)
    return levels


def _scatter(g_tables: torch.Tensor, feat: int, ax: _Axis, lo: torch.Tensor, hi: torch.Tensor) -> None:
    """Add lo [N, F] to row i and hi to row i + 1 of one packed line grad."""
    grad = g_tables[ax.offset : ax.offset + ax.res * feat].view(ax.res, feat)
    grad.index_add_(0, ax.i, lo)
    grad.index_add_(0, ax.i + 1, hi)


def encode_plain(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """K3's contract in plain PyTorch, on the same inputs."""
    levels = _axes(resolutions, feat, tables, x01)
    return torch.cat([a[0].f * a[1].f * a[2].f for a in levels], dim=-1)


def encode_bwd_plain(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K4's contract in plain PyTorch, with `encode_bwd_cuda`'s returns."""
    g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=tables.device) if tables_half else None
    g_coords = torch.zeros((x01.shape[0], 3), dtype=torch.float32, device=x01.device) if coords_half else None
    for lvl, axes in enumerate(_axes(resolutions, feat, tables, x01)):
        g_l = g[:, lvl * feat : (lvl + 1) * feat]
        for a, ax in enumerate(axes):
            G = g_l * axes[(a + 1) % 3].f * axes[(a + 2) % 3].f
            if tables_half:
                _scatter(g_tables, feat, ax, (1.0 - ax.w) * G, ax.w * G)
            if coords_half:
                g_coords[:, a] += (G * ax.d).sum(-1)
    return g_tables, g_coords


def grad_dot_plain(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """K5's contract in plain PyTorch, on the same inputs."""
    s = torch.zeros((x01.shape[0], 3), dtype=torch.float32, device=x01.device)
    for lvl, axes in enumerate(_axes(resolutions, feat, tables, x01)):
        g_l = g[:, lvl * feat : (lvl + 1) * feat]
        for a, ax in enumerate(axes):
            s[:, a] += (ax.d * axes[(a + 1) % 3].f * axes[(a + 2) % 3].f * g_l).sum(-1)
    return s


def grad_dot_bwd_plain(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    g: torch.Tensor,
    ct: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K6's contract in plain PyTorch, with `grad_dot_bwd_cuda`'s returns."""
    g_tables = g_g = g_coords = None
    if tables_half:
        g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=tables.device)
        g_g = torch.empty_like(g)
    if coords_half:
        g_coords = torch.zeros((x01.shape[0], 3), dtype=torch.float32, device=x01.device)
    c = [ct[:, a : a + 1] for a in range(3)]
    for lvl, axes in enumerate(_axes(resolutions, feat, tables, x01)):
        g_l = g[:, lvl * feat : (lvl + 1) * feat]
        f = [ax.f for ax in axes]
        d = [ax.d for ax in axes]
        if tables_half:
            g_g[:, lvl * feat : (lvl + 1) * feat] = (
                c[0] * d[0] * f[1] * f[2] + c[1] * f[0] * d[1] * f[2] + c[2] * f[0] * f[1] * d[2]
            )
        for a, ax in enumerate(axes):
            b, cc = (a + 1) % 3, (a + 2) % 3
            g_hat = c[b] * g_l * d[b] * f[cc] + c[cc] * g_l * d[cc] * f[b]
            if tables_half:
                g_dhat = c[a] * g_l * f[b] * f[cc]
                _scatter(g_tables, feat, ax, (1.0 - ax.w) * g_hat - ax.s * g_dhat, ax.w * g_hat + ax.s * g_dhat)
            if coords_half:
                g_coords[:, a] += (g_hat * d[a]).sum(-1)
    return g_tables, g_g, g_coords


def grad_plain(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """K8's contract in plain PyTorch, on the same inputs: [N, 3, L F]."""
    levels = _axes(resolutions, feat, tables, x01)
    return torch.cat(
        [torch.stack([ax[a].d * ax[(a + 1) % 3].f * ax[(a + 2) % 3].f for a in range(3)], dim=1) for ax in levels],
        dim=-1,
    )


def grad_bwd_plain(
    resolutions: Sequence[int],
    feat: int,
    tables: torch.Tensor,
    x01: torch.Tensor,
    ct: torch.Tensor,
    tables_half: bool = True,
    coords_half: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K9's contract in plain PyTorch, with `grad_bwd_cuda`'s returns."""
    g_tables = torch.zeros(tables.numel(), dtype=torch.float32, device=tables.device) if tables_half else None
    g_coords = torch.zeros((x01.shape[0], 3), dtype=torch.float32, device=x01.device) if coords_half else None
    for lvl, axes in enumerate(_axes(resolutions, feat, tables, x01)):
        c = [ct[:, a, lvl * feat : (lvl + 1) * feat] for a in range(3)]
        f = [ax.f for ax in axes]
        d = [ax.d for ax in axes]
        for a, ax in enumerate(axes):
            b, cc = (a + 1) % 3, (a + 2) % 3
            g_hat = c[b] * d[b] * f[cc] + c[cc] * d[cc] * f[b]
            if tables_half:
                g_dhat = c[a] * f[b] * f[cc]
                _scatter(g_tables, feat, ax, (1.0 - ax.w) * g_hat - ax.s * g_dhat, ax.w * g_hat + ax.s * g_dhat)
            if coords_half:
                g_coords[:, a] += (g_hat * d[a]).sum(-1)
    return g_tables, g_coords


def dense_encode_plain(
    resolutions: Sequence[int], feat: int, tables: torch.Tensor, x01: torch.Tensor
) -> torch.Tensor:
    """K10's contract in plain PyTorch, on the same inputs: the two nonzero
    hat weights rounded to bf16, exact products with the bf16 rows summed
    in f32, the axes multiplied in f32."""
    u = x01.clamp(0.0, 1.0)
    tab = tables.float()
    feats, offset = [], 0
    for res in resolutions:
        prod = None
        for ax in range(3):
            line = tab[offset : offset + res * feat].view(res, feat)
            x = u[:, ax] * (res - 1)
            i = x.floor().clamp(0, res - 2)
            h0 = (1.0 - (x - i).abs()).to(torch.bfloat16).float()[:, None]
            h1 = (1.0 - (x - (i + 1)).abs()).to(torch.bfloat16).float()[:, None]
            i = i.long()
            f = h0 * line[i] + h1 * line[i + 1]
            prod = f if prod is None else prod * f
            offset += res * feat
        feats.append(prod)
    return torch.cat(feats, dim=-1)
