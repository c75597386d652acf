"""The yardstick's arithmetic: published H100 peaks, the least time a call
can take at them, and the kernel table that files device time by name.

Frozen copies, so that a later change to the program cannot move the
yardstick: the bounds are `chip_smoke.py`'s (`bound`, `factor_bounds`),
the kernel grouping is `signerf_tpu_torch/utils/microbench.kernel_breakdown`'s
rule (a kernel belongs to the first group that names it), with the port's
kernels matched by their whole identifiers.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# (group, names). A port kernel is matched by its whole identifier; the
# library groups by substrings. The first group that matches wins.
PORT_KERNEL_NAMES: Sequence[Tuple[str, Sequence[str]]] = (
    ("K1", ("density_kernel",)),
    ("K2", ("density_bwd_tables_kernel", "density_bwd_coords_kernel")),
    ("K3", ("encode_kernel",)),
    ("K4", ("encode_bwd_tables_kernel", "encode_bwd_dot_kernel")),
    ("K5", ("grad_dot_kernel",)),
    ("K6", ("grad_dot_bwd_tables_kernel", "grad_dot_bwd_coords_kernel")),
    ("K7", ("flash_attention_kernel",)),
    ("K8_K9", ("grad_kernel", "grad_bwd_tables_kernel", "grad_bwd_coords_kernel")),
)
LIBRARY_GROUPS: Sequence[Tuple[str, Sequence[str]]] = (
    ("nccl", ("nccl",)),
    ("conv", ("conv", "cudnn", "implicit_gemm", "winograd", "fft", "dgrad", "wgrad", "fprop")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
)
GROUPS = tuple(g for g, _ in PORT_KERNEL_NAMES) + tuple(g for g, _ in LIBRARY_GROUPS) + ("other",)
FACTOR_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")
_PORT_RE = [(g, re.compile("|".join(rf"(?<![A-Za-z0-9_]){n}(?![A-Za-z0-9_])" for n in names)))
            for g, names in PORT_KERNEL_NAMES]


def group_of(kernel_name: str) -> str:
    for group, pattern in _PORT_RE:
        if pattern.search(kernel_name):
            return group
    low = kernel_name.lower()
    for group, keys in LIBRARY_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def group_ms(kernels_ms: Dict[str, float]) -> Dict[str, float]:
    out = {g: 0.0 for g in GROUPS}
    for name, ms in kernels_ms.items():
        out[group_of(name)] += ms
    return out


def bound_ms(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0) -> float:
    """The least ms of one call: each input read once and each output
    written once at HBM's rate, against its operations at the peak rate of
    their type; the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops)


def factor_bounds(resolutions: Iterable[int], feat: int, n: int, hidden: int = 0, out: int = 0) -> Dict[str, float]:
    """Least ms of the factor-grid work on one call of N samples: L levels
    of F features (D = L F) from three bf16 line tables a level, and a
    2-layer bf16 MLP D -> hidden -> out where the call runs one. The f32
    operation counts are the taps' lerps and products (11 L F a sample
    forward, 12 L F backward), as `chip_smoke.factor_bounds` counts them."""
    res = list(resolutions)
    d = len(res) * feat
    table_elems = 3 * feat * sum(res)
    tab, grads = 2 * table_elems, 4 * table_elems
    mlp_w = 2 * (d * hidden + hidden + hidden * out + out)
    mlp = 2 * n * (d * hidden + hidden * out)
    enc, enc_bwd = 11 * d * n, 12 * d * n
    x, g_feat = 12 * n, 4 * n * d
    return {
        "density": bound_ms(x + tab + mlp_w + 4 * n * out, mlp, enc),
        "density_bwd": bound_ms(x + 4 * n * out + tab + mlp_w + grads + 2 * mlp_w, 3 * mlp, enc + enc_bwd),
        "encode": bound_ms(x + tab + g_feat, 0, enc),
        "encode_bwd": bound_ms(x + g_feat + tab + grads, 0, enc + enc_bwd),
        "grad_dot": bound_ms(x + g_feat + tab + x, 0, enc + enc_bwd),
        "grad_dot_bwd": bound_ms(x + g_feat + x + tab + grads + g_feat, 0, enc + 2 * enc_bwd),
    }
