"""Analytic FLOP counts for the nerfacto render and train paths and the SDXL
denoise step, and the utilization they give at a measured rate.

Port of `signerf_tpu/ops/flops.py`. The hardware-neutral counts (`mlp_flops`,
the SDXL shape interpreter `unet_flops`, `controlnet_flops`,
`sdxl_denoise_step_flops` and their helpers) are the JAX package's, line for
line. Its nerfacto encode count is not: it counts the TPU kernels'
dense-hat GEMMs with their tile padding, work the port's kernels do not do.
`nerfacto_flops` counts what the port executes instead, split by the unit
that runs it on the H100:

- tensor cores (bf16 operands, f32 sums): the 2-layer density MLPs inside
  K1 (forward) and K2 (backward), for every field whose density takes the
  fused path;
- CUDA cores (f32): the encode of K1 to K4, per level and axis a two-tap
  interpolation (1 - w) a + w b of each feature (three operations) and the
  three axes' product (two), and every Dense layer outside the kernels (the
  color and pred-normal heads, the linear proposal networks' Dense, the base
  MLP with gradient normals or ``use_fused_density=False``), which run as
  f32 products over bf16-rounded operands.

Conventions, as in JAX: a multiply-add is 2 FLOPs and a GEMM [M, K] x [K, N]
is 2 M K N; the train path counts the forward three times (Dense backward =
dL/dW + dL/dx; the encode backward re-runs the taps and scatters two rows);
the gradient normals' contraction (K5, K6) is not counted. The peaks are the
published H100 SXM dense rates that `chip_smoke.py`'s bounds use.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Sequence, Tuple

from signerf_tpu_torch.ops.factor_grid import FactorGridConfig

BF16_FLOP_PER_S = 989e12  # tensor cores, dense
F32_FLOP_PER_S = 67e12  # CUDA cores


def mlp_flops(dims: Sequence[int]) -> int:
    """Per-sample GEMM FLOPs of a Dense chain with layer widths `dims`
    (input, hidden..., out)."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def factor_encode_flops(cfg: FactorGridConfig) -> int:
    """Per-sample f32 FLOPs of the port's CP encode (K1, K3): per level,
    axis and feature a two-tap interpolation (3), per level and feature the
    three axes' product (2)."""
    return len(cfg.resolutions) * cfg.features_per_level * (3 * 3 + 2)


@dataclasses.dataclass(frozen=True)
class NerfactoFlops:
    """Per-ray FLOPs of one nerfacto configuration, split into tensor-core
    (`*_tc`, bf16) and CUDA-core (`*_f32`) work, per sample of each field.
    `render_per_ray` and `train_per_ray` keep the JAX package's meaning."""

    field_encode: int  # f32, per nerf sample
    field_mlp_tc: int  # the base MLP inside K1, per nerf sample
    field_mlp_f32: int  # the Dense layers outside the kernels, per nerf sample
    proposal_encode: Tuple[int, ...]  # f32, per proposal sample, one entry per net
    proposal_mlp_tc: Tuple[int, ...]
    proposal_mlp_f32: Tuple[int, ...]

    nerf_samples: int
    proposal_samples: Tuple[int, ...]

    @property
    def render_tc_per_ray(self) -> int:
        return self.nerf_samples * self.field_mlp_tc + sum(
            n * f for n, f in zip(self.proposal_samples, self.proposal_mlp_tc)
        )

    @property
    def render_f32_per_ray(self) -> int:
        per = self.nerf_samples * (self.field_encode + self.field_mlp_f32)
        for n, e, m in zip(self.proposal_samples, self.proposal_encode, self.proposal_mlp_f32):
            per += n * (e + m)
        return per

    @property
    def render_per_ray(self) -> int:
        return self.render_tc_per_ray + self.render_f32_per_ray

    @property
    def train_tc_per_ray(self) -> int:
        return 3 * self.render_tc_per_ray

    @property
    def train_f32_per_ray(self) -> int:
        return 3 * self.render_f32_per_ray

    @property
    def train_per_ray(self) -> int:
        return 3 * self.render_per_ray


def _default(cls, name: str):
    return inspect.signature(cls.__init__).parameters[name].default


def nerfacto_flops(model_config) -> NerfactoFlops:
    """The per-ray FLOP model of a `NerfactoModelConfig` (factor backend),
    with the fields as `models/nerfacto.py` builds them: base field 8
    levels x 16 features, base MLP enc -> 64 -> 16, color head (16 SH + 15
    geo + 32 appearance) -> 64 -> 64 -> 3, proposal fields 5 levels x 8
    features and enc -> 16 -> 1 (or enc -> 1 with `use_linear`)."""
    from signerf_tpu_torch.models.fields import HashMLPDensityField, NerfactoField

    c = model_config
    field_cfg = FactorGridConfig(
        num_levels=_default(NerfactoField, "factor_num_levels"),
        base_res=c.base_res,
        max_res=c.max_res,
        features_per_level=_default(NerfactoField, "factor_features_per_level"),
    )
    geo = _default(NerfactoField, "geo_feat_dim")
    sh_dim = _default(NerfactoField, "sh_levels") ** 2
    fused = c.use_fused_density
    # the base MLP runs inside K1 / K2 unless the gradient normals take the
    # encode (K3) and the MLP outside the kernels
    base_in_kernel = fused and not (c.predict_normals and c.use_gradient_normals)
    base = mlp_flops([field_cfg.out_dim, c.hidden_dim, 1 + geo])
    head_in = sh_dim + geo + (c.appearance_embed_dim if c.use_appearance_embedding else 0)
    heads = mlp_flops([head_in, c.hidden_dim_color, c.hidden_dim_color, 3])
    if c.predict_normals:
        heads += mlp_flops([geo + sh_dim, 64, 64, 3])

    enc, tc, f32 = [], [], []
    for args in c.proposal_net_args_list:
        pcfg = FactorGridConfig(
            num_levels=args.num_levels,
            base_res=16,
            max_res=args.max_res,
            features_per_level=_default(HashMLPDensityField, "factor_features_per_level"),
        )
        enc.append(factor_encode_flops(pcfg))
        if args.use_linear:
            tc.append(0)
            f32.append(mlp_flops([pcfg.out_dim, 1]))
        else:
            mlp = mlp_flops([pcfg.out_dim, args.hidden_dim, 1])
            tc.append(mlp if fused else 0)
            f32.append(0 if fused else mlp)

    return NerfactoFlops(
        field_encode=factor_encode_flops(field_cfg),
        field_mlp_tc=base if base_in_kernel else 0,
        field_mlp_f32=heads + (0 if base_in_kernel else base),
        proposal_encode=tuple(enc),
        proposal_mlp_tc=tuple(tc),
        proposal_mlp_f32=tuple(f32),
        nerf_samples=c.num_nerf_samples_per_ray,
        proposal_samples=tuple(c.num_proposal_samples_per_ray),
    )


def utilization(flops_per_ray: float, rays_per_sec: float, peak_flops: float) -> float:
    """The share of a unit's peak, in percent, that `flops_per_ray` at
    `rays_per_sec` keeps busy (`BF16_FLOP_PER_S` for the tensor cores,
    `F32_FLOP_PER_S` for the CUDA cores)."""
    return 100.0 * flops_per_ray * rays_per_sec / peak_flops


def breakdown_str(f: NerfactoFlops) -> str:
    """The render path's per-ray budget, row by row."""
    rows = [
        ("field encode (f32)", f.nerf_samples * f.field_encode),
        ("field MLPs (tensor cores)", f.nerf_samples * f.field_mlp_tc),
        ("field MLPs (f32)", f.nerf_samples * f.field_mlp_f32),
    ]
    for i, n in enumerate(f.proposal_samples):
        rows.append((f"proposal {i} ({n} samples)", n * (f.proposal_encode[i] + f.proposal_mlp_tc[i]
                                                        + f.proposal_mlp_f32[i])))
    total = f.render_per_ray
    return "\n".join(
        f"  {name:28s} {fl / 1e6:8.3f} MFLOP/ray  ({100 * fl / total:4.1f}%)" for name, fl in rows
    )


# ---------------------------------------------------------------------------
# SDXL UNet + ControlNet denoise-step FLOPs (shape interpreter)
# ---------------------------------------------------------------------------


def _conv2d_flops(hw, cin, cout, k=3, stride=1):
    oh, ow = hw[0] // stride, hw[1] // stride
    return 2 * k * k * cin * cout * oh * ow, (oh, ow)


def _resnet_flops(hw, cin, cout, time_dim):
    f, _ = _conv2d_flops(hw, cin, cout)
    f += 2 * time_dim * cout  # time_emb_proj (per sample, 1 "token")
    f += _conv2d_flops(hw, cout, cout)[0]
    if cin != cout:
        f += _conv2d_flops(hw, cin, cout, k=1)[0]
    return f


def _transformer_flops(hw, c, depth, ctx_len, cross_dim):
    """Transformer2D: proj_in/out + depth x (self-attn, cross-attn, GEGLU ff).

    Attention score/value GEMMs count 2*T*T'*c each regardless of head
    split (heads partition c)."""
    t = hw[0] * hw[1]
    f = 2 * 2 * c * c * t  # proj_in + proj_out
    per = 0
    per += 4 * 2 * c * c * t  # self q,k,v,out
    per += 2 * 2 * t * t * c  # self QK^T + AV
    per += 2 * 2 * c * c * t  # cross q + out (over image tokens)
    per += 2 * 2 * cross_dim * c * ctx_len  # cross k,v (over text tokens)
    per += 2 * 2 * t * ctx_len * c  # cross QK^T + AV
    per += 2 * c * (8 * c) * t  # GEGLU proj (dim_out*2 = 8c)
    per += 2 * (4 * c) * c * t  # ff_out
    return f + depth * per


def unet_flops(
    ucfg,
    latent_hw: Tuple[int, int],
    ctx_len: int = 77,
    encoder_only: bool = False,
) -> int:
    """Per-sample GEMM FLOPs of one UNet forward (`diffusion/unet.py`),
    tracked with the exact residual-stack channel bookkeeping of the up
    path. `encoder_only=True` gives the ControlNet core (down + mid only)."""
    chans = list(ucfg.block_out_channels)
    time_dim = chans[0] * 4
    hw = latent_hw
    total = 0
    # time/add embeds: tiny Denses, counted for completeness
    total += 2 * (chans[0] * time_dim + time_dim * time_dim)
    total += 2 * (
        ucfg.projection_class_embeddings_input_dim * time_dim
        + time_dim * time_dim
    )

    total += _conv2d_flops(hw, ucfg.in_channels, chans[0])[0]  # conv_in
    h_ch = chans[0]
    residuals = [(h_ch, hw)]
    for i, ch in enumerate(chans):
        depth = ucfg.transformer_layers[i]
        for _ in range(ucfg.layers_per_block):
            total += _resnet_flops(hw, h_ch, ch, time_dim)
            h_ch = ch
            if depth > 0:
                total += _transformer_flops(
                    hw, ch, depth, ctx_len, ucfg.cross_attention_dim
                )
            residuals.append((h_ch, hw))
        if i < len(chans) - 1:
            f, hw = _conv2d_flops(hw, ch, ch, stride=2)
            total += f
            residuals.append((ch, hw))

    # mid
    total += _resnet_flops(hw, h_ch, chans[-1], time_dim)
    if ucfg.transformer_layers[-1] > 0:
        total += _transformer_flops(
            hw, chans[-1], ucfg.transformer_layers[-1], ctx_len,
            ucfg.cross_attention_dim,
        )
    total += _resnet_flops(hw, chans[-1], chans[-1], time_dim)
    h_ch = chans[-1]

    if encoder_only:
        return total

    for i, ch in enumerate(reversed(chans)):
        block_idx = len(chans) - 1 - i
        depth = ucfg.transformer_layers[block_idx]
        for _ in range(ucfg.layers_per_block + 1):
            res_ch, _res_hw = residuals.pop()
            total += _resnet_flops(hw, h_ch + res_ch, ch, time_dim)
            h_ch = ch
            if depth > 0:
                total += _transformer_flops(
                    hw, ch, depth, ctx_len, ucfg.cross_attention_dim
                )
        if i < len(chans) - 1:
            hw = (hw[0] * 2, hw[1] * 2)
            total += _conv2d_flops(hw, ch, ch)[0]

    total += _conv2d_flops(hw, h_ch, ucfg.out_channels)[0]  # conv_out
    return total


def controlnet_flops(ucfg, latent_hw, ctx_len: int = 77) -> int:
    """ControlNet-depth forward: conditioning stem at pixel resolution +
    encoder-only core + 1x1 zero convs."""
    steps = 3  # SDXL pixel->latent stem
    hw = (latent_hw[0] * (2 ** steps), latent_hw[1] * (2 ** steps))
    total = _conv2d_flops(hw, 3, 16)[0]
    stem = ((16, 32), (32, 96), (96, 256))
    for same_ch, next_ch in stem:
        total += _conv2d_flops(hw, same_ch, same_ch)[0]
        f, hw = _conv2d_flops(hw, same_ch, next_ch, stride=2)
        total += f
    total += _conv2d_flops(hw, 256, ucfg.block_out_channels[0])[0]
    total += unet_flops(ucfg, latent_hw, ctx_len, encoder_only=True)
    # zero convs: one 1x1 per residual + mid; residual count =
    # 1 (conv_in) + layers_per_block*len(chans) + (len(chans)-1) downsamples
    chans = list(ucfg.block_out_channels)
    res_hw = latent_hw
    total += _conv2d_flops(res_hw, chans[0], chans[0], k=1)[0]
    for i, ch in enumerate(chans):
        for _ in range(ucfg.layers_per_block):
            total += _conv2d_flops(res_hw, ch, ch, k=1)[0]
        if i < len(chans) - 1:
            res_hw = (res_hw[0] // 2, res_hw[1] // 2)
            total += _conv2d_flops(res_hw, ch, ch, k=1)[0]
    total += _conv2d_flops(res_hw, chans[-1], chans[-1], k=1)[0]  # mid
    return total


def sdxl_denoise_step_flops(
    ucfg, latent_hw, ctx_len: int = 77, cfg_batch: int = 2,
    controlnet: bool = True,
) -> int:
    """One sampler step: UNet (+ControlNet) over the CFG-duplicated batch."""
    per = unet_flops(ucfg, latent_hw, ctx_len)
    if controlnet:
        per += controlnet_flops(ucfg, latent_hw, ctx_len)
    return cfg_batch * per
