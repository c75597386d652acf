"""Builds and loads the port's CUDA kernels (every `csrc/*.cu`).

Each source is compiled by `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared` into its own library under `build/kernels/` at the repository root
(git-ignored), all compilers started together, at first use and again
whenever the source, the headers it includes or the flags change (the
library's name carries their hash). The libraries have a plain C interface
(no PyTorch headers, so a build takes seconds) and are loaded with ctypes;
every exported function returns the launch's `cudaGetLastError()`.

The wrappers (`fused_factor_cuda.py` for K1 to K6 and K8 to K10,
`flash_attention.py` for K7) call `library(name)` and read nothing else of this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_FACTOR_HEADER = _CSRC / "factor_grid_common.cuh"
_DOT_HEADER = _CSRC / "grad_dot_tiles.cuh"  # K5's tile loop, also run by K4 and K6
# library name -> (source, headers it includes); a header enters only the
# build keys of the sources that include it.
SOURCES: Dict[str, Tuple[Path, Tuple[Path, ...]]] = {
    "fused_factor_density": (_CSRC / "fused_factor_density.cu", (_FACTOR_HEADER,)),  # K1
    "fused_factor_density_bwd": (_CSRC / "fused_factor_density_bwd.cu", (_FACTOR_HEADER,)),  # K2
    "fused_factor_encode": (_CSRC / "fused_factor_encode.cu", (_FACTOR_HEADER, _DOT_HEADER)),  # K3, K4, K10
    "fused_factor_grad_dot": (_CSRC / "fused_factor_grad_dot.cu", (_FACTOR_HEADER, _DOT_HEADER)),  # K5, K6
    "fused_factor_grad": (_CSRC / "fused_factor_grad.cu", (_FACTOR_HEADER,)),  # K8, K9
    "flash_attention": (_CSRC / "flash_attention.cu", ()),  # K7
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# Exported C function -> ctypes argtypes (each returns int, a cudaError_t).
ARGTYPES = {
    "fused_factor_density_forward": [
        _P, _I,  # coords [N, 3] f32, N
        _P, ctypes.POINTER(_I), _I,  # packed tables bf16, resolutions (host), levels
        _I, _I, _I,  # features_per_level, hidden, out
        _P, _P, _P, _P,  # w0 [D, H], b0 [H], w1 [H, O], b1 [O], bf16
        _P,  # out [N, O] f32
        _P,  # cudaStream_t
    ],
    "fused_factor_density_backward": [
        _P, _P, _I,  # coords [N, 3] f32, grad_out [N, O] f32, N
        _P, ctypes.POINTER(_I), _I,  # packed tables bf16, resolutions (host), levels
        _I, _I, _I,  # features_per_level, hidden, out
        _P, _P, _P,  # w0 [D, H], b0 [H], w1 [H, O], bf16
        _P, _P, _P, _P, _P,  # grads: tables (packed), w0, b0, w1, b1, f32, zeroed
        _P,  # grad coords [N, 3] f32
        _I,  # mode: 0 tables, 1 coords
        _P,  # cudaStream_t
    ],
    "fused_factor_density_backward_occupancy": [
        ctypes.POINTER(_I), _I,  # resolutions (host), levels
        _I, _I, _I, _I,  # features_per_level, hidden, out, mode (0 tables, 1 coords)
        ctypes.POINTER(_I), ctypes.POINTER(_I),  # (host) dynamic shared bytes, blocks per SM
    ],
    "fused_factor_encode_forward": [
        _P, _I,  # coords [N, 3] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P,  # out [N, D] f32
        _P,  # cudaStream_t
    ],
    "fused_factor_encode_backward": [
        _P, _P, _I,  # coords [N, 3] f32, g [N, D] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P, _P,  # grads: tables (packed, f32, zeroed), coords [N, 3] f32 (written)
        _I,  # mode: 0 tables, 1 coords
        _P,  # cudaStream_t
    ],
    "factor_dense_encode_forward": [
        _P, _I,  # coords [N, 3] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P,  # out [N, D] f32
        _P,  # cudaStream_t
    ],
    "fused_factor_grad_forward": [
        _P, _I,  # coords [N, 3] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P,  # out [N, 3, D] f32
        _P,  # cudaStream_t
    ],
    "fused_factor_grad_backward": [
        _P, _P, _I,  # coords [N, 3] f32, ct [N, 3, D] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P, _P,  # grads: tables (packed, f32, zeroed), coords [N, 3] f32
        _I,  # mode: 0 tables, 1 coords
        _P,  # cudaStream_t
    ],
    "fused_factor_grad_dot_forward": [
        _P, _P, _I,  # coords [N, 3] f32, g [N, D] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P,  # out [N, 3] f32
        _P,  # cudaStream_t
    ],
    "fused_factor_grad_dot_backward": [
        _P, _P, _P, _I,  # coords [N, 3] f32, g [N, D] f32, ct [N, 3] f32, N
        _P, ctypes.POINTER(_I), _I, _I,  # packed tables bf16, resolutions (host), levels, F
        _P, _P, _P,  # grads: tables (packed, f32, zeroed), g [N, D], coords [N, 3], f32
        _I,  # mode: 0 tables, 1 coords
        _P,  # cudaStream_t
    ],
    "flash_attention_forward": [
        _P, _P, _P,  # q, k, v bf16 [B, S, H, 64], last axis contiguous
        ctypes.POINTER(ctypes.c_longlong),  # (host) element strides: q b, s, h; k b, s, h; v b, s, h
        _I, _I, _I,  # B, S, H
        ctypes.c_float,  # softmax scale
        _P,  # out bf16 [B, S, H * 64], contiguous
        _P,  # cudaStream_t
    ],
}

# The last build's compiler output (registers, shared memory, spills).
build_log = ""

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _target(lib_name: str) -> Path:
    src, headers = SOURCES[lib_name]
    blob = src.read_bytes() + b"".join(h.read_bytes() for h in headers) + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{lib_name}_{hashlib.sha256(blob).hexdigest()[:16]}.so"


def library(name: str) -> ctypes.CDLL:
    """Build (the sources that changed, all compilers at once) and load
    every kernel library; returns the one called `name`."""
    global build_log
    with _lock:
        if not _libs:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            targets = {lib_name: _target(lib_name) for lib_name in SOURCES}
            procs = {}
            for lib_name, so in targets.items():
                if so.exists():
                    continue
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[lib_name][0])]
                procs[lib_name] = (
                    subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                    tmp,
                )
            logs, failed = [], []
            for lib_name, (proc, tmp) in procs.items():
                out, _ = proc.communicate()
                logs.append(out)
                if proc.returncode != 0:
                    failed.append(f"{SOURCES[lib_name][0].name}:\n{out}")
                else:
                    os.replace(tmp, targets[lib_name])
            build_log = "".join(logs)
            if failed:
                raise RuntimeError("nvcc failed to build " + "\n".join(failed))
            for lib_name, so in targets.items():
                lib = ctypes.CDLL(str(so))
                for fn_name, argtypes in ARGTYPES.items():
                    if hasattr(lib, fn_name):
                        fn = getattr(lib, fn_name)
                        fn.restype = ctypes.c_int
                        fn.argtypes = argtypes
                _libs[lib_name] = lib
        return _libs[name]
