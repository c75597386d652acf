"""flax-style Dense and Conv layers for the diffusion port, and the random
init that mirrors flax's distributions.

The layers carry flax's parameter names (`kernel`, `bias`) so that a JAX
params tree maps onto the port's `state_dict` by joining paths with dots
(`convert.sdxl_from_jax`). Dense kernels keep flax's [in, out] layout; conv
kernels are OIHW for `F.conv2d`. Parameters are bf16, as the pipeline
holds them, and both layers compute as flax does with `dtype=bfloat16`:
inputs cast to bf16, the product rounded to bf16, then the bias added in
bf16 (a second rounding, as in JAX). Activations
are NHWC at every module boundary, as in the JAX package; a conv permutes
to NCHW and back, which on the card is free when the tensor and the kernel
are channels_last in memory (the pipeline converts the kernels once).

Under tensor parallelism a Dense holds a `Shard` of its whole kernel:
columns (q, k, v, GEGLU's proj: each rank computes its own outputs) or
rows (to_out, ff_out: each rank's partial product is summed over the
tensor group by `reduce` before the bias, which every rank holds whole and
adds once, after the sum). `init_flax_` draws a sharded kernel whole from
the generator and keeps the shard, so every tensor size holds the same
weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's part of a whole parameter: the `spans` [start, stop) of the
    whole's axis `dim`, in order, concatenated."""

    dim: int
    spans: Tuple[Tuple[int, int], ...]

    @property
    def size(self) -> int:
        return sum(b - a for a, b in self.spans)

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        parts = [whole.narrow(self.dim, a, b - a) for a, b in self.spans]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)


class Dense(nn.Module):
    """`in_features` and `out_features` are the whole layer's. With a
    `shard` of dim 1 the kernel holds those output columns (and the bias
    the same entries); with dim 0 those input rows, and `reduce` sums the
    partial products over the tensor group before the whole bias."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, shard: Optional[Shard] = None,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        super().__init__()
        self.whole_shape = (in_features, out_features)
        self.shard, self.reduce = shard, reduce
        if shard is not None and shard.dim == 0:
            in_features = shard.size
        elif shard is not None:
            out_features = shard.size
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, dtype=BF16))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=BF16)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(BF16), self.kernel)
        if self.reduce is not None:
            y = self.reduce(y)
        return y if self.bias is None else y + self.bias


class Conv(nn.Module):
    """NHWC in and out. `padding` is an int (symmetric, as flax's int) or
    ((top, bottom), (left, right))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding=0, zero_init: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, dtype=BF16))
        self.bias = nn.Parameter(torch.empty(out_ch, dtype=BF16))
        self.stride = stride
        self.padding = padding
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(BF16).permute(0, 3, 1, 2)
        if isinstance(self.padding, int):
            pad = self.padding
        else:
            (top, bottom), (left, right) = self.padding
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        y = F.conv2d(x, self.kernel, None, self.stride, pad)
        return (y + self.bias.view(1, -1, 1, 1)).permute(0, 2, 3, 1)


class Embed(nn.Module):
    """flax nn.Embed: a table `embedding` [num, features] read by index."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features, dtype=BF16))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x nearest upsample, `jax.image.resize(..., "nearest")` at 2x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to +-2 std, rescaled to
    variance 1 / fan_in; drawn in f32 and rounded into t."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device).uniform_(lo, hi, generator=gen)
    t.copy_(torch.erfinv(u * 2 - 1) * (math.sqrt(2) * std))


@torch.no_grad()
def init_flax_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter in place with flax's default distribution for
    its role: lecun-normal Dense and Conv kernels (zero-init convs at 0),
    zero biases, norm scales 1, embeddings normal(1 / sqrt(features)), CLIP
    position embeddings normal(0.01). Works on parameters materialised
    with `to_empty`, one f32 draw at a time."""
    from signerf_tpu_torch.diffusion.clip import CLIPTextModel
    from signerf_tpu_torch.diffusion.norms import GroupNormBF16, LayerNorm, LayerNormBF16

    for mod in module.modules():
        if isinstance(mod, Dense) and mod.shard is not None:
            whole = torch.empty(mod.whole_shape, dtype=torch.float32, device=mod.kernel.device)
            _lecun_normal_(whole, mod.whole_shape[0], gen)
            mod.kernel.copy_(mod.shard.take(whole))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (Dense, Conv)):
            if isinstance(mod, Conv) and mod.zero_init:
                mod.kernel.zero_()
            else:
                shape = mod.kernel.shape
                fan_in = shape[0] if isinstance(mod, Dense) else shape[1] * shape[2] * shape[3]
                _lecun_normal_(mod.kernel, fan_in, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (GroupNormBF16, LayerNormBF16, LayerNorm)):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Embed):
            w = torch.empty(mod.embedding.shape, dtype=torch.float32, device=mod.embedding.device)
            mod.embedding.copy_(w.normal_(0.0, 1.0 / math.sqrt(mod.embedding.shape[1]), generator=gen))
        if isinstance(mod, CLIPTextModel):
            p = mod.position_embedding
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            p.copy_(w.normal_(0.0, 0.01, generator=gen))
    return module


def count_params(module: nn.Module) -> Tuple[int, int]:
    """(parameters, bytes)."""
    n = sum(p.numel() for p in module.parameters())
    return n, sum(p.numel() * p.element_size() for p in module.parameters())

