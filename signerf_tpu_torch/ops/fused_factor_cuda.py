"""K1: the factor-grid encode + density MLP as a hand-written CUDA kernel.

Replaces `fused_factor_density_tpu` in `signerf_tpu/ops/fused_factor_pallas.py`
(the Pallas TPU kernel that the proposal fields and the base field call
once each per ray chunk). The kernel source is `csrc/fused_factor_density.cu`;
its header says what it computes, what bounds it on an H100 (two-row gathers
and their latency for the proposals, FMAs for the base MLP on CUDA cores)
and what the design does about it.

The TPU kernel's dense-hat block GEMM, its 9-row one-hot GEMM and its
transposed [D, N] layout existed only because the TPU has no fast gather;
the port keeps the function, not that schedule: each level and axis is a
two-row gather, and the output is [N, O] row-major.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` into
`build/kernels/` at the repository root, at first use and again whenever
the source's hash changes, then loaded with ctypes (plain C interface, no
PyTorch headers, so a build takes seconds).

`density_mlp_plain` is the kernel's plain PyTorch twin on the same packed
inputs. `factor_grid.fused_density_mlp` takes it for CPU tensors; the tests
and `chip_smoke.py` hold the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

from signerf_tpu_torch.ops.factor_grid import mlp2_reference

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_factor_density.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# (features_per_level, hidden, out, levels) the kernel is instantiated for:
# the proposal fields and the base field of `signerf_nerfacto`.
SUPPORTED = {(8, 16, 1, 5), (16, 64, 16, 8)}

# Launches of the kernel in this process; only `density_mlp_cuda` adds to it,
# once per launch. `chip_smoke.py` resets and reads it.
launches = 0
# The last build's compiler output (registers, shared memory, spills).
build_log = ""

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library() -> ctypes.CDLL:
    """Build (when the source changed) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"fused_factor_density_{digest[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True,
                text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {_SOURCE.name}:\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.fused_factor_density_forward
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # coords [N, 3] f32
            ctypes.c_int,  # N
            ctypes.c_void_p,  # packed tables, bf16
            ctypes.POINTER(ctypes.c_int),  # resolutions (host)
            ctypes.c_int,  # num_levels
            ctypes.c_int,  # features_per_level
            ctypes.c_int,  # hidden
            ctypes.c_int,  # out
            ctypes.c_void_p,  # w0 [D, H] bf16
            ctypes.c_void_p,  # b0 [H] bf16
            ctypes.c_void_p,  # w1 [H, O] bf16
            ctypes.c_void_p,  # b1 [O] bf16
            ctypes.c_void_p,  # out [N, O] f32
            ctypes.c_void_p,  # cudaStream_t
        ]
        _lib = lib
        return lib


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
        raise RuntimeError(f"{name} requires grad; the kernel is forward-only")


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
    device = x01.device
    if device.type != "cuda":
        raise ValueError(f"density_mlp_cuda needs CUDA tensors, got {device}")
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
    _check("b1", b1, bf16, (out_dim,), device)
    if tables.data_ptr() % 16:
        raise ValueError("tables must be 16-byte aligned for the vector loads")
    if n >= 2**31:
        raise ValueError(f"N={n} does not fit the kernel's int count")

    lib = library()
    out = torch.empty((n, out_dim), dtype=torch.float32, device=device)
    res = (ctypes.c_int * levels)(*resolutions)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_factor_density_forward(
            x01.data_ptr(), n, tables.data_ptr(), res, levels, feat, hidden, out_dim,
            w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_factor_density_forward failed with CUDA error {rc}")
    launches += 1
    return out


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
    """The kernel's contract in plain PyTorch, on the same inputs."""
    u = x01.clamp(0.0, 1.0)
    feats = []
    offset = 0
    for res in resolutions:
        prod = None
        for ax in range(3):
            line = tables[offset : offset + res * feat].view(res, feat).float()
            offset += res * feat
            x = u[:, ax] * (res - 1)
            i = x.floor().clamp(0, res - 2)
            w = (x - i)[:, None]
            i = i.long()
            f = (1.0 - w) * line[i] + w * line[i + 1]
            prod = f if prod is None else prod * f
        feats.append(prod)
    return mlp2_reference(torch.cat(feats, dim=-1), ((w0, b0), (w1, b1)))
