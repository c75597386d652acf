"""CLIP text encoders (ViT-L and OpenCLIP bigG text towers) in PyTorch (the
port of `signerf_tpu/diffusion/clip.py`).

SDXL's dual text conditioning: the 77-token prompt runs through both
towers; the penultimate hidden states (768 + 1280 = 2048) become the
cross-attention context, bigG's projected EOS embedding the pooled
`add_text_embeds`. Pre-LN causal transformer in bf16; the layer norms are
flax's `nn.LayerNorm` in f32 (eps 1e-6); the causal mask puts
`finfo(bf16).min` into the bf16 scores before an f32 softmax. The attention
over 77 tokens is a plain matmul, as in JAX (it is not K7's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from signerf_tpu_torch.diffusion.layers import Dense, Embed
from signerf_tpu_torch.diffusion.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    hidden_act: str = "quick_gelu"  # ViT-L; bigG uses "gelu"
    projection_dim: Optional[int] = None  # bigG: 1280


CLIP_L_CONFIG = CLIPTextConfig()
CLIP_BIGG_CONFIG = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_layers=32,
    num_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    # jax.nn.gelu's default is the tanh approximation (open_clip uses erf);
    # matched on purpose.
    return F.gelu(x, approximate="tanh")


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        hs = config.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Dense(hs, hs) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        head_dim = cfg.hidden_size // cfg.num_heads

        def split(t):
            return t.view(*t.shape[:-1], cfg.num_heads, head_dim)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        bf16 = torch.bfloat16
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(math.sqrt(head_dim), dtype=bf16)
        scores = torch.where(mask, scores, torch.tensor(torch.finfo(bf16).min, dtype=bf16))
        probs = torch.softmax(scores.float(), dim=-1).to(bf16)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(*x.shape[:-1], cfg.hidden_size)
        return self.out_proj(out)


class CLIPLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.act = config.hidden_act
        self.layer_norm1 = LayerNorm(config.hidden_size)
        self.self_attn = CLIPAttention(config)
        self.layer_norm2 = LayerNorm(config.hidden_size)
        self.fc1 = Dense(config.hidden_size, config.intermediate_size)
        self.fc2 = Dense(config.intermediate_size, config.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(_act(self.act, self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """ids [B, S] -> (final [B, S, H] f32, penultimate [B, S, H] bf16,
    pooled [B, H] f32[, projected [B, P] bf16])."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.token_embedding = Embed(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Parameter(torch.empty(config.max_positions, config.hidden_size,
                                                           dtype=torch.bfloat16))
        for i in range(config.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(config))
        self.final_layer_norm = LayerNorm(config.hidden_size)
        if config.projection_dim is not None:
            self.text_projection = Dense(config.hidden_size, config.projection_dim, use_bias=False)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.config
        b, s = input_ids.shape
        x = (self.token_embedding(input_ids) + self.position_embedding[None, :s]).to(torch.bfloat16)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=input_ids.device))[None, None]
        penultimate = None
        for i in range(cfg.num_layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = getattr(self, f"layers_{i}")(x, causal)
        final = self.final_layer_norm(x)
        # pooled: the final hidden state at the EOS token (the largest id)
        pooled = final[torch.arange(b, device=input_ids.device), input_ids.argmax(dim=-1)]
        if cfg.projection_dim is not None:
            return final, penultimate, pooled, self.text_projection(pooled)
        return final, penultimate, pooled
