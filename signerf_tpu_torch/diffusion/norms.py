"""Normalisation for the diffusion port, at the JAX package's rounding points
(`signerf_tpu/diffusion/norms.py`, and flax's `nn.LayerNorm` for CLIP).

- `GroupNormBF16`: bf16 in and out; one-pass f32 statistics E[x^2] - E[x]^2
  clamped at 0; the scale and bias folded with the statistics into one
  per-channel affine applied in f32 and rounded once.
- `LayerNormBF16`: bf16 in and out; two-pass f32 statistics, eps 1e-6.
- `LayerNorm`: flax `nn.LayerNorm(dtype=float32)` as CLIP uses it: one-pass
  statistics clamped at 0, eps 1e-6 (flax's default, where the CLIP
  checkpoints were trained with 1e-5; matched on purpose), f32 output.

Parameters are named `scale` and `bias`, as in flax. They are held in the
model's dtype (bf16) and promoted to f32 in the affine, as JAX promotes them.
Channels are the last axis.
"""

from __future__ import annotations

import torch
from torch import nn


class GroupNormBF16(nn.Module):
    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-5, dtype=torch.bfloat16):
        super().__init__()
        assert channels % num_groups == 0, (channels, num_groups)
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(b, -1, g, c // g)
        mean = xf.mean(dim=(1, 3))  # [B, G]
        sqmean = xf.square().mean(dim=(1, 3))
        var = (sqmean - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.epsilon)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mul = a.repeat_interleave(c // g, dim=-1).view(shape) * self.scale.float()
        add = self.bias.float() - mean.repeat_interleave(c // g, dim=-1).view(shape) * mul
        return (x.float() * mul + add).to(x.dtype)


class LayerNormBF16(nn.Module):
    def __init__(self, channels: int, epsilon: float = 1e-6, dtype=torch.bfloat16):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, channels: int, epsilon: float = 1e-6, dtype=torch.bfloat16):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        return (xf - mean) * mul + self.bias.float()
