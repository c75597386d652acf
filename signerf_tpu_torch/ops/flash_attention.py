"""K7: softmax self-attention at head_dim 64, hand-written in CUDA.

Replaces the Pallas TPU flash-attention kernel that
`signerf_tpu/diffusion/unet.py:216-268` (`_flash_self_attention`) calls in
every UNet and ControlNet self-attention of the SDXL inpaint. The kernel
is `csrc/flash_attention.cu` (a FlashAttention-3 style forward for sm_90a:
wgmma for both products, TMA loads into a ring of mbarrier stages, a
producer warpgroup and three consumers, one persistent CTA an SM; its header
says what bounds it and how), built by `cuda_build`. The C entry point
describes q, k and v to the TMA with tensor maps built on the host from
their pointers and strides (`cuTensorMapEncodeTiled`, found through
`cudaGetDriverEntryPoint`, so the library links no libcuda).

Contract (the JAX function's): q, k, v [B, S, H, 64] bf16 -> [B, S, H*64]
bf16, softmax(q k^T * scale) v per batch row and head, softmax in f32. The
TPU wrapper padded S to 128 tokens with segment ids for its block shapes;
the CUDA kernel masks the ragged tail itself and reads q, k and v through
their strides, so the `to_q`/`to_k`/`to_v` outputs go in without a copy.

`flash_attention` launches the kernel for CUDA tensors (or raises) and
takes the plain twin `flash_attention_plain` only for CPU tensors. The twin
is the einsum path of `unet.py:341-343` with JAX's rounding points: bf16
scores, `* scale` in bf16, f32 softmax, probabilities rounded to bf16, bf16
PV. The kernel keeps the scores in f32, so the two differ by bf16 rounding
of the scores (tests/test_torch_cuda.py and chip_smoke.py state the bound).
"""

from __future__ import annotations

import ctypes
import math

import torch

from signerf_tpu_torch.ops.cuda_build import library

HEAD_DIM = 64

# Launches in this process; only `flash_attention_cuda` adds to it, once per
# launch. `chip_smoke.py` resets and reads it.
launches = 0


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head_dim axis must be contiguous")
    # TMA reads a tensor whose base and strides are multiples of 16 bytes.
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 8")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad; K7 is forward only")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch K7 on q's stream: q, k, v [B, S, H, 64] bf16 -> [B, S, H*64] bf16.

    Raises for anything the kernel does not take (device, dtype, head_dim,
    layout) and when the launch fails."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"K7 needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"K7 takes q [B, S, H, {HEAD_DIM}], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        _check(name, t, (b, s, h, d))
    if b * s >= 2**31 or s < 1:
        raise ValueError(f"B x S = {b} x {s} is out of the kernel's range")
    out = torch.empty((b, s, h * d), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = library("flash_attention").flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, b, s, h, float(scale), out.data_ptr(), stream
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_forward failed with CUDA error {rc}")
    launches += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K7's contract in plain PyTorch, at the einsum path's rounding points."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * torch.tensor(scale, dtype=q.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float = 1.0 / math.sqrt(HEAD_DIM)) -> torch.Tensor:
    """K7 for CUDA tensors, its plain twin for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return flash_attention_cuda(q, k, v, scale)
