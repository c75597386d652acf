"""SDXL UNet2DConditionModel and its ControlNet twin in PyTorch, NHWC at the
module boundaries (the port of `signerf_tpu/diffusion/unet.py`).

Topology, parameter names and rounding points are the JAX package's:
block_out_channels (320, 640, 1280), layers_per_block 2, transformer depths
(0, 2, 10), head dim 64, cross-attention context 2048, "text_time" added
conditioning. Every module computes in bf16 as flax does with
`dtype=bfloat16`; where JAX promotes to f32 (ControlNet residuals scaled by
an f32 gain and added to the bf16 skips), the port promotes too.

Self-attention (`attn1`) goes to K7 (`ops/flash_attention.py`, a CUDA
kernel) when the tensor is on the card, the head dim is 64, the block was
built with `use_flash` and the process-wide `FLASH_ATTENTION` switch is on;
everything else, and every CPU tensor, takes the einsum path of
`unet.py:341-343`, which is K7's plain twin. The JAX package's
`FLASH_BLOCK_TABLE`, `FLASH_BLOCK_SIZES` and 2 GiB score gate are TPU
tilings and a TPU memory valve and do not gate K7 (it never holds the
scores); `FLASH_SCORE_BYTES_THRESHOLD` stays as the einsum-memory model
the pipeline's sequential-CFG and serial-views gates read.

Tensor parallelism (the JAX package's `tensor_parallel_pspecs` over a
"tensor" mesh axis, Megatron style): built with a `TensorShard` of rank r
in a group of T, each attention holds the q, k and v columns of heads
[r H / T, (r + 1) H / T) and the same rows of `to_out`, and runs its
attention (K7 for `attn1`) on those local heads; GEGLU's `proj` holds the
matching slices of both its halves, h and gate, and `ff_out` the same
rows. The row-parallel products are summed over the group in f32 and
rounded to bf16 once, then the bias is added (JAX's psum sums the bf16
partials in bf16). A block whose head count, or FF width, T does not
divide runs whole on every rank, as JAX's meshed flash falls back to
einsum for such a layer. Everything else (convs, norms, embeddings, the
VAE and both CLIPs) is replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signerf_tpu_torch.diffusion.layers import Conv, Dense, Shard, upsample_nearest_2x
from signerf_tpu_torch.diffusion.norms import GroupNormBF16, LayerNormBF16
from signerf_tpu_torch.ops.flash_attention import HEAD_DIM, flash_attention, flash_attention_plain


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers: Tuple[int, ...] = (0, 2, 10)  # per down block
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    norm_groups: int = 32
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816  # 1280 + 6*256
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_flash_attention: bool = True  # self-attention may take K7 (see the gate)


SDXL_UNET_CONFIG = UNetConfig()

TINY_UNET_CONFIG = UNetConfig(
    block_out_channels=(16, 32),
    layers_per_block=1,
    transformer_layers=(1, 1),
    attention_head_dim=8,
    cross_attention_dim=32,
    norm_groups=4,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8,
)

FLASH_ATTENTION = True  # process-wide switch: False sends every attention to the einsum twin
# The einsum path's score bytes (2 * B * H * Sq * Sk) above which the JAX
# package needed flash on a 16 GB TPU; the pipeline's sequential-CFG and
# serial-views gates keep this model so that both packages schedule (and
# draw noise) alike.
FLASH_SCORE_BYTES_THRESHOLD = 2 << 30


def set_flash_attention(enabled: bool) -> None:
    global FLASH_ATTENTION
    FLASH_ATTENTION = enabled


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """Rank `rank` of a tensor group of `size` ranks; `all_sum` sums a
    tensor over the group in place (`DataMesh.tensor_all_sum_`)."""

    rank: int = 0
    size: int = 1
    all_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def divides(self, n: int) -> bool:
        """Whether a layer of n heads (or FF columns) is sharded."""
        return self.size > 1 and n % self.size == 0

    def shard(self, dim: int, whole: int, blocks: int = 1) -> Shard:
        """This rank's 1/T of each of `blocks` equal blocks of an axis of `whole`."""
        n = whole // blocks
        part = n // self.size
        return Shard(dim, tuple((b * n + self.rank * part, b * n + (self.rank + 1) * part) for b in range(blocks)))

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """The row-parallel products (bf16), summed over the group in f32,
        rounded to bf16 once."""
        return self.all_sum(partial.float()).to(torch.bfloat16)


WHOLE = TensorShard()


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, shift: int = 0) -> torch.Tensor:
    """Sinusoidal embedding [B] -> [B, dim] f32 (diffusers convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[..., None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], -1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _gn(channels: int, groups: int) -> GroupNormBF16:
    return GroupNormBF16(channels, groups, epsilon=1e-5)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, temb_dim: int):
        super().__init__()
        self.norm1 = _gn(in_ch, groups)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Dense(temb_dim, out_ch)
        self.norm2 = _gn(out_ch, groups)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int, head_dim: int, use_flash: bool = True,
                 tp: TensorShard = WHOLE):
        super().__init__()
        inner = num_heads * head_dim
        cols = rows = reduce = None
        if tp.divides(num_heads):  # this rank's heads; else whole on every rank
            cols, rows, reduce = tp.shard(1, inner), tp.shard(0, inner), tp.reduce
            num_heads //= tp.size
        self.num_heads, self.head_dim, self.use_flash = num_heads, head_dim, use_flash
        self.to_q = Dense(query_dim, inner, use_bias=False, shard=cols)
        self.to_k = Dense(context_dim, inner, use_bias=False, shard=cols)
        self.to_v = Dense(context_dim, inner, use_bias=False, shard=cols)
        self.to_out = Dense(inner, query_dim, shard=rows, reduce=reduce)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        self_attn = context is None
        context = x if self_attn else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, sq, _ = q.shape
        sk = k.shape[1]
        q = q.view(b, sq, self.num_heads, self.head_dim)
        k = k.view(b, sk, self.num_heads, self.head_dim)
        v = v.view(b, sk, self.num_heads, self.head_dim)
        scale = 1.0 / math.sqrt(self.head_dim)
        if self_attn and self.use_flash and FLASH_ATTENTION and self.head_dim == HEAD_DIM:
            out = flash_attention(q, k, v, scale)  # K7 on the card, its twin on the CPU
        else:
            out = flash_attention_plain(q, k, v, scale)
        return self.to_out(out)


class GEGLU(nn.Module):
    """`proj` computes [h | gate]; under tensor parallelism a rank holds
    the same 1/T of both halves (`shard` of 2 blocks), so that its h and
    its gate pair up, and returns that 1/T of the output columns."""

    def __init__(self, dim: int, dim_out: int, shard: Optional[Shard] = None):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, shard=shard)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # jax.nn.gelu's default is the tanh approximation (diffusers uses
        # erf); matched on purpose.
        return h * F.gelu(gate, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int, use_flash: bool = True,
                 tp: TensorShard = WHOLE):
        super().__init__()
        self.norm1 = LayerNormBF16(dim)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, use_flash, tp)
        self.norm2 = LayerNormBF16(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim, tp=tp)
        self.norm3 = LayerNormBF16(dim)
        width = dim * 4
        sharded = tp.divides(width)
        self.ff_geglu = GEGLU(dim, width, tp.shard(1, 2 * width, blocks=2) if sharded else None)
        self.ff_out = Dense(width, dim, shard=tp.shard(0, width) if sharded else None,
                            reduce=tp.reduce if sharded else None)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, depth: int, num_heads: int, head_dim: int, groups: int, context_dim: int,
                 use_flash: bool = True, tp: TensorShard = WHOLE):
        super().__init__()
        self.depth = depth
        self.norm = _gn(ch, groups)
        self.proj_in = Dense(ch, ch)
        for i in range(depth):
            self.add_module(f"blocks_{i}", BasicTransformerBlock(ch, num_heads, head_dim, context_dim, use_flash,
                                                                 tp))
        self.proj_out = Dense(ch, ch)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for i in range(self.depth):
            y = getattr(self, f"blocks_{i}")(y, context)
        return x + self.proj_out(y).reshape(b, h, w, c)


class UNetCore(nn.Module):
    """The encoder (+ mid) trunk shared by the UNet and the ControlNet.

    `encoder_only` returns (down_residuals, mid_hidden, temb); otherwise the
    eps prediction [B, H, W, C_out] f32. ControlNet residuals are added to
    the skips before the up path. `pooled_dim` is the width of
    `add_text_embeds` (flax infers `add_embed_1`'s input width from the
    call; by default the config's `projection_class_embeddings_input_dim`
    less the six time ids). `tp`: this rank's tensor shard."""

    def __init__(self, config: UNetConfig, encoder_only: bool = False, pooled_dim: Optional[int] = None,
                 tp: TensorShard = WHOLE):
        super().__init__()
        cfg = self.config = config
        self.encoder_only = encoder_only
        chans = cfg.block_out_channels
        time_dim = chans[0] * 4
        groups, hd, ctx = cfg.norm_groups, cfg.attention_head_dim, cfg.cross_attention_dim
        self.time_embed_1 = Dense(chans[0], time_dim)
        self.time_embed_2 = Dense(time_dim, time_dim)
        if pooled_dim is None:
            pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        self.add_embed_1 = Dense(pooled_dim + 6 * cfg.addition_time_embed_dim, time_dim)
        self.add_embed_2 = Dense(time_dim, time_dim)
        self.conv_in = Conv(cfg.in_channels, chans[0], 3, padding=1)
        skips, prev = [chans[0]], chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(prev, ch, groups, time_dim))
                if cfg.transformer_layers[i] > 0:
                    self.add_module(f"down_{i}_attn_{j}", Transformer2D(
                        ch, cfg.transformer_layers[i], ch // hd, hd, groups, ctx, cfg.use_flash_attention, tp))
                prev = ch
                skips.append(ch)
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_1 = ResnetBlock2D(chans[-1], chans[-1], groups, time_dim)
        if cfg.transformer_layers[-1] > 0:
            self.mid_attn = Transformer2D(chans[-1], cfg.transformer_layers[-1], chans[-1] // hd, hd, groups, ctx,
                                          cfg.use_flash_attention, tp)
        self.mid_res_2 = ResnetBlock2D(chans[-1], chans[-1], groups, time_dim)
        if encoder_only:
            return
        for i, ch in enumerate(reversed(chans)):
            block = len(chans) - 1 - i
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock2D(prev + skips.pop(), ch, groups, time_dim))
                if cfg.transformer_layers[block] > 0:
                    self.add_module(f"up_{i}_attn_{j}", Transformer2D(
                        ch, cfg.transformer_layers[block], ch // hd, hd, groups, ctx, cfg.use_flash_attention, tp))
                prev = ch
            if i < len(chans) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.conv_norm_out = _gn(chans[0], groups)
        self.conv_out = Conv(chans[0], cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # [B, H, W, C_in]
        timesteps: torch.Tensor,  # [B]
        context: torch.Tensor,  # [B, S, cross_dim]
        add_text_embeds: torch.Tensor,  # [B, pooled_dim]
        add_time_ids: torch.Tensor,  # [B, 6]
        extra_down_residuals: Optional[Sequence[torch.Tensor]] = None,
        extra_mid_residual: Optional[torch.Tensor] = None,
        conditioning: Optional[torch.Tensor] = None,  # ControlNet stem output
    ):
        cfg = self.config
        chans = cfg.block_out_channels
        temb = timestep_embedding(timesteps, chans[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb.to(torch.bfloat16))))
        tids = timestep_embedding(add_time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                  cfg.freq_shift).reshape(add_time_ids.shape[0], -1)
        add = torch.cat([add_text_embeds.float(), tids], dim=-1).to(torch.bfloat16)
        temb = temb + self.add_embed_2(F.silu(self.add_embed_1(add)))
        context = context.to(torch.bfloat16)

        h = self.conv_in(sample)
        if conditioning is not None:
            h = h + conditioning
        residuals: List[torch.Tensor] = [h]
        for i in range(len(chans)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[i] > 0:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                residuals.append(h)
            if i < len(chans) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                residuals.append(h)
        h = self.mid_res_1(h, temb)
        if cfg.transformer_layers[-1] > 0:
            h = self.mid_attn(h, context)
        h = self.mid_res_2(h, temb)
        if self.encoder_only:
            return residuals, h, temb

        if extra_mid_residual is not None:
            h = h + extra_mid_residual
        if extra_down_residuals is not None:
            residuals = [r + e for r, e in zip(residuals, extra_down_residuals)]
        for i in range(len(chans)):
            block = len(chans) - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, residuals.pop()], dim=-1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[block] > 0:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i < len(chans) - 1:
                h = getattr(self, f"up_{i}_upsample")(upsample_nearest_2x(h))
        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h).float()


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, pooled_dim: Optional[int] = None, tp: TensorShard = WHOLE):
        super().__init__()
        self.config = config
        self.core = UNetCore(config, pooled_dim=pooled_dim, tp=tp)

    def forward(self, sample, timesteps, context, add_text_embeds, add_time_ids, extra_down_residuals=None,
                extra_mid_residual=None):
        return self.core(sample, timesteps, context, add_text_embeds, add_time_ids, extra_down_residuals,
                         extra_mid_residual)


class ControlNet(nn.Module):
    """ControlNet-depth: the UNet's encoder copy, the conditioning stem of
    diffusers' ControlNetConditioningEmbedding (conv_in 16, pairs
    16->32->96->256 with stride 2 on every second conv, zero conv_out) and
    zero-initialised 1x1 convs. Returns (down_residuals, mid_residual)."""

    def __init__(self, config: UNetConfig, cond_downscale_steps: int = 3, cond_channels: int = 3,
                 pooled_dim: Optional[int] = None, tp: TensorShard = WHOLE):
        super().__init__()
        self.config = config
        self.cond_conv_in = Conv(cond_channels, 16, 3, padding=1)
        prev, blk = 16, 0
        self.stem = len(((16, 32), (32, 96), (96, 256))[:cond_downscale_steps])
        for same_ch, next_ch in ((16, 32), (32, 96), (96, 256))[:cond_downscale_steps]:
            self.add_module(f"cond_block_{blk}", Conv(prev, same_ch, 3, padding=1))
            self.add_module(f"cond_block_{blk + 1}", Conv(same_ch, next_ch, 3, stride=2, padding=1))
            prev, blk = next_ch, blk + 2
        chans = config.block_out_channels
        self.cond_conv_out = Conv(prev, chans[0], 3, padding=1, zero_init=True)
        self.core = UNetCore(config, encoder_only=True, pooled_dim=pooled_dim, tp=tp)
        skips = [chans[0]]
        for i, ch in enumerate(chans):
            skips += [ch] * (config.layers_per_block + (i < len(chans) - 1))
        for i, ch in enumerate(skips):
            self.add_module(f"zero_conv_{i}", Conv(ch, ch, 1, zero_init=True))
        self.num_residuals = len(skips)
        self.zero_conv_mid = Conv(chans[-1], chans[-1], 1, zero_init=True)

    def forward(self, sample, cond_image, timesteps, context, add_text_embeds, add_time_ids):
        c = F.silu(self.cond_conv_in(cond_image))
        for blk in range(2 * self.stem):
            c = F.silu(getattr(self, f"cond_block_{blk}")(c))
        cond = self.cond_conv_out(c)
        residuals, mid, _ = self.core(sample, timesteps, context, add_text_embeds, add_time_ids, conditioning=cond)
        down = [getattr(self, f"zero_conv_{i}")(r) for i, r in enumerate(residuals)]
        return down, self.zero_conv_mid(mid)
