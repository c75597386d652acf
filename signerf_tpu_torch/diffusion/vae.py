"""AutoencoderKL (the SDXL VAE) in PyTorch, NHWC at the module boundaries
(the port of `signerf_tpu/diffusion/vae.py`).

GroupNorm + SiLU resnet stacks and one single-head spatial attention in
each mid block; latent scaling factor 0.13025. The encoder and decoder are
split into their conv-only, full-resolution halves (`encode_down`,
`decode_up`) and their latent-resolution halves with the global attention
(`encode_from_features`, `decode_mid`), for the windowed sheet path of the
pipeline. The downsample convs pad ((0, 1), (0, 1)) and stride 2, as flax
does (symmetric padding 1 would shift every latent). The mid attention
(head dim 512) is a plain matmul, as in JAX; above `ATTN_CHUNK_TOKENS`
tokens it runs in blocks of `ATTN_QUERY_CHUNK` queries, each with the
whole key axis, so the softmax is exact and the scores stay [chunk, S].
The encoders return the posterior mean unless the caller passes a
`torch.Generator` or the standard normal draw itself (`noise`): then a
posterior sample, as the JAX `encode(rng=...)`. The pipeline never
samples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signerf_tpu_torch.diffusion.layers import Conv, Dense, upsample_nearest_2x
from signerf_tpu_torch.diffusion.norms import GroupNormBF16

SDXL_VAE_SCALING = 0.13025
ATTN_CHUNK_TOKENS = 8192
ATTN_QUERY_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = SDXL_VAE_SCALING


TINY_VAE_CONFIG = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=4)


def _gn(channels: int, groups: int) -> GroupNormBF16:
    return GroupNormBF16(channels, groups, epsilon=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = _gn(in_ch, groups)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch, groups)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _plain_attention(q, k, v):
    sqrt_c = torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    return _softmax_pv(torch.matmul(q, k.transpose(1, 2)) / sqrt_c, v)


def _chunked_attention(q, k, v):
    """Query-blocked `_plain_attention` (the JAX version multiplies by the
    bf16 reciprocal of the bf16 sqrt(C); so does this)."""
    scale = 1.0 / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    kt = k.transpose(1, 2)
    outs = [_softmax_pv(torch.matmul(q[:, i : i + ATTN_QUERY_CHUNK], kt) * scale, v)
            for i in range(0, q.shape[1], ATTN_QUERY_CHUNK)]
    return torch.cat(outs, dim=1)


class AttnBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = _gn(ch, groups)
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(ch, ch) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attend = _chunked_attention if h * w > ATTN_CHUNK_TOKENS else _plain_attention
        return x + self.to_out(attend(q, k, v)).reshape(b, h, w, c)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        chans, groups = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = Conv(3, chans[0], 3, padding=1)
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(prev, ch, groups))
                prev = ch
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2, padding=((0, 1), (0, 1))))
        self.mid_res_1 = ResnetBlock(chans[-1], chans[-1], groups)
        self.mid_attn = AttnBlock(chans[-1], groups)
        self.mid_res_2 = ResnetBlock(chans[-1], chans[-1], groups)
        self.conv_norm_out = _gn(chans[-1], groups)
        self.conv_out = Conv(chans[-1], 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = Conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def down(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> conv-only features [B, H/2^k, W/2^k, C_last]."""
        cfg = self.config
        h = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        return h

    def mid_out(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Down features -> the posterior's (mean, logvar) (the global
        attention runs here)."""
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h)))
        h = self.quant_conv(self.conv_out(F.silu(self.conv_norm_out(h))))
        c = self.config.latent_channels
        return h[..., :c], h[..., c:]


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        chans, groups = cfg.block_out_channels, cfg.norm_groups
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = Conv(cfg.latent_channels, chans[-1], 3, padding=1)
        self.mid_res_1 = ResnetBlock(chans[-1], chans[-1], groups)
        self.mid_attn = AttnBlock(chans[-1], groups)
        self.mid_res_2 = ResnetBlock(chans[-1], chans[-1], groups)
        prev = chans[-1]
        for i, ch in enumerate(reversed(chans)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(prev, ch, groups))
                prev = ch
            if i < len(chans) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.conv_norm_out = _gn(chans[0], groups)
        self.conv_out = Conv(chans[0], 3, 3, padding=1)

    def mid(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents -> latent-resolution features (global attention)."""
        h = self.conv_in(self.post_quant_conv(z))
        return self.mid_res_2(self.mid_attn(self.mid_res_1(h)))

    def up(self, h: torch.Tensor) -> torch.Tensor:
        """Latent-resolution features -> image [B, H, W, 3] in [-1, 1] (conv only)."""
        cfg = self.config
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(upsample_nearest_2x(h))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)

    def _latents(self, moments, generator: Optional[torch.Generator], noise: Optional[torch.Tensor]):
        """(mean, logvar) -> scaled latents: the mean, or with `generator`
        (a standard normal draw) or `noise` (the draw itself, e.g. JAX's)
        the posterior sample mean + exp(0.5 clip(logvar, -30, 20)) eps, in
        the mean's dtype."""
        mean, logvar = moments
        if generator is not None or noise is not None:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * noise.to(device=mean.device, dtype=mean.dtype)
        return mean * self.config.scaling_factor

    def encode(
        self, images: torch.Tensor, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> scaled latents [B, H/2^k, W/2^k, C]
        bf16: the posterior mean, or a sample of it (see `_latents`)."""
        return self._latents(self.encoder.mid_out(self.encoder.down(images)), generator, noise)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images [B, H, W, 3] in [-1, 1] bf16."""
        return self.decoder.up(self.decoder.mid(latents / self.config.scaling_factor))

    def encode_down(self, images: torch.Tensor) -> torch.Tensor:
        """Conv-only encoder features (no attention, fully local)."""
        return self.encoder.down(images)

    def encode_from_features(
        self, feats: torch.Tensor, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Down features -> scaled latents (mid attention + output convs),
        the posterior mean or a sample of it (see `_latents`)."""
        return self._latents(self.encoder.mid_out(feats), generator, noise)

    def decode_mid(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> latent-resolution decoder features (the global
        attention runs here, over the full latent)."""
        return self.decoder.mid(latents / self.config.scaling_factor)

    def decode_up(self, feats: torch.Tensor) -> torch.Tensor:
        """Latent-resolution decoder features -> image (conv only, local)."""
        return self.decoder.up(feats)
