"""Neural fields: the nerfacto field and the proposal density field.

Port of `signerf_tpu/models/fields.py`, both encoding backends: the
factorized grid ("factor", the default) and the instant-ngp hash grid
("hash", nerfstudio's `HashEncoding`); any other name raises. Parameter
names follow the flax modules, so the `state_dict` keys are the JAX tree
paths joined with dots, for example `field.encoding.line_0_0`,
`field.encoding.table` (hash), `proposal_0.HashGridEncoding_0.table` and
`field.mlp_base.dense_0.kernel`. Dense kernels keep flax's [in, out]
layout.

With the factor backend the density of both fields goes through
`ops/factor_grid.fused_density_mlp`: the CUDA kernels (K1 forward, K2
backward) for a CUDA tensor, their plain twins for a CPU tensor. With
gradient normals the base field's density and its spatial gradient come
instead from `factor_density_geo_and_grad`: the encode (K3, K4) and the
grad-dot contraction (K5, K6) on the card. A linear proposal field
(`use_linear`) and ``use_fused_density=False`` take the features from the
encoding module instead (`FactorGridEncoding.forward`: K3, K4 on the card).
With the hash backend the density is `ops/hashgrid.hashgrid_encode` (plain
PyTorch, as the JAX function is plain `jnp`) then the bf16 `MLP`. The
color, pred-normal and base MLPs and the linear proposals' Dense outside
the kernels stay plain PyTorch under the same bf16 Dense contract.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from signerf_tpu_torch.ops.contraction import contract_to_unit, contract_to_unit_jacobian
from signerf_tpu_torch.ops.factor_grid import (
    FactorGridConfig,
    cp_level_features,
    cp_level_features_and_grad,
    dense_bf16,
    encode_fused,
    fused_density_mlp,
    grad_encode_dot,
    grad_encode_fused,
    plane_features,
)
from signerf_tpu_torch.ops.hashgrid import hashgrid_encode, hashgrid_resolutions, init_hashgrid_table
from signerf_tpu_torch.ops.sh import sh_encode

ENCODING_BACKENDS = ("factor", "hash")


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)) whose derivative is that same clamped exp
    everywhere (instant-ngp / nerfstudio `trunc_exp`, the JAX package's
    `custom_jvp`), so samples far outside the clamp keep learning."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(x.clamp(-15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with the input clamped to [-15, 15] (the density activation)."""
    return _TruncExp.apply(x)


class Dense(nn.Module):
    """flax `Dense(dtype=bfloat16)`: f32 params `kernel` [in, out] and
    `bias` [out]; the forward follows `factor_grid.dense_bf16`."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal: truncated normal on [-2, 2] std, variance 1/fan_in.
        std = math.sqrt(1.0 / self.kernel.shape[0]) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.bias.zero_()

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.kernel, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_bf16(x, self.kernel, self.bias)


class MLP(nn.Module):
    """ReLU MLP of `num_layers` Dense layers (`dense_0`, `dense_1`, ...),
    bf16 compute over f32 params; the output is returned as f32."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        num_layers: int,
        out_dim: int,
        out_activation: Optional[str] = None,
    ):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"dense_{i}", Dense(dims[i], dims[i + 1]))
        self.num_layers = num_layers
        self.out_activation = out_activation

    def layers(self):
        return [getattr(self, f"dense_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.layers()
        for layer in hidden:
            x = torch.relu(layer(x))
        x = last(x)
        if self.out_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x


class FactorGridEncoding(nn.Module):
    """The learned line tables `line_{lvl}_{ax}`, each [R_lvl, F], and with
    `include_planes` the planes `plane_01`, `plane_02` and `plane_12`, each
    [R_p, R_p, F_p] (flax's names and inits).

    `forward` is the JAX module's `__call__`: the CP levels through
    `encode_fused` (K3 forward, K4 backward on the card; their plain twins
    on the CPU), the plane terms through the XLA expression
    (`plane_features`), or everything through the XLA expression when the
    caller asks for it with ``use_fused=False``."""

    PLANE_AXES = ((0, 1), (0, 2), (1, 2))

    def __init__(self, config: FactorGridConfig):
        super().__init__()
        self.config = config
        for lvl, res in enumerate(config.resolutions):
            for ax in range(3):
                self.register_parameter(
                    f"line_{lvl}_{ax}", nn.Parameter(torch.empty(res, config.features_per_level))
                )
        if config.include_planes:
            shape = (config.plane_res, config.plane_res, config.plane_features)
            for a, b in self.PLANE_AXES:
                self.register_parameter(f"plane_{a}{b}", nn.Parameter(torch.empty(shape)))

    @property
    def out_dim(self) -> int:
        return self.config.out_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.normal_(0.0, 0.02 if name.startswith("plane_") else 0.2, generator=generator)

    def get_lines(self):
        """The [level][axis] line tables, as `fused_density_mlp` takes them."""
        return [
            [getattr(self, f"line_{lvl}_{ax}") for ax in range(3)]
            for lvl in range(len(self.config.resolutions))
        ]

    def forward(self, positions01: torch.Tensor, use_fused: Optional[bool] = None) -> torch.Tensor:
        """positions01 [..., 3] (clipped to [0, 1]) -> features [..., D] f32."""
        cfg = self.config
        dtype = getattr(torch, cfg.compute_dtype)
        x = positions01.reshape(-1, 3).clamp(0.0, 1.0)
        lines = self.get_lines()
        if use_fused is False:
            feats = [cp_level_features(x, lines[lvl], dtype) for lvl in range(len(lines))]
        else:
            feats = [encode_fused(cfg, lines, x)]
        if cfg.include_planes:
            feats += [
                plane_features(x, getattr(self, f"plane_{a}{b}"), (a, b), dtype) for a, b in self.PLANE_AXES
            ]
        out = torch.cat([f.float() for f in feats], dim=-1)
        return out.reshape(*positions01.shape[:-1], cfg.out_dim)

    def encode_with_grad(self, positions01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions01 [..., 3] (clipped to [0, 1]) -> (features [..., D],
        d features / d positions01 [..., 3, D]), both f32 and
        differentiable in the line tables: `encode_fused` (K3, K4) and
        `grad_encode_fused` (K8, K9) on the card, their plain twins on the
        CPU. CP levels only, as in JAX; its XLA expression is
        `cp_level_features_and_grad`."""
        cfg = self.config
        if cfg.include_planes:
            raise ValueError("encode_with_grad: analytic gradients exist for the CP levels only")
        x = positions01.reshape(-1, 3).clamp(0.0, 1.0)
        lines = self.get_lines()
        feats = encode_fused(cfg, lines, x)
        dfeats = grad_encode_fused(cfg, lines, x)
        batch = positions01.shape[:-1]
        return feats.reshape(*batch, cfg.out_dim), dfeats.reshape(*batch, 3, cfg.out_dim)


class HashGridEncoding(nn.Module):
    """The learned multiresolution hash table `table` [L, 2^log2, F] f32."""

    def __init__(
        self,
        num_levels: int = 16,
        features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
    ):
        super().__init__()
        self.resolutions = hashgrid_resolutions(num_levels, base_res, max_res)
        self.table = nn.Parameter(torch.empty(num_levels, 2**log2_hashmap_size, features_per_level))

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * self.table.shape[2]

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.table.copy_(init_hashgrid_table(generator, *self.table.shape))

    def forward(self, positions01: torch.Tensor) -> torch.Tensor:
        return hashgrid_encode(self.table, positions01, self.resolutions)


def _check_backend(encoding_backend: str) -> None:
    if encoding_backend not in ENCODING_BACKENDS:
        raise ValueError(f"encoding_backend={encoding_backend!r}: one of {ENCODING_BACKENDS}")


def _density_logits(
    encoding: FactorGridEncoding, mlp: MLP, positions: torch.Tensor
) -> torch.Tensor:
    """positions [..., 3] world -> raw MLP outputs [..., O] through the
    fused encode + density MLP."""
    pos01 = contract_to_unit(positions)
    x = pos01.reshape(-1, 3).clamp(0.0, 1.0)
    ws = [layer.weights() for layer in mlp.layers()]
    h = fused_density_mlp(encoding.config, encoding.get_lines(), ws, x)
    return h.reshape(*pos01.shape[:-1], h.shape[-1])


class NerfactoField(nn.Module):
    """Density + color field with an appearance embedding.

    The encoding is `encoding`: a `FactorGridEncoding` (factor backend) or
    a `HashGridEncoding` (hash backend, `num_levels` x `features_per_level`
    features from a table of 2^`log2_hashmap_size` entries a level).
    ``use_fused_density=False`` (the JAX debug switch) runs the factor
    backend's density as the encoding module and then `mlp_base` instead
    of the fused encode + MLP (K1, K2).
    `forward(positions [R, S, 3], directions [R, 3])` returns
    {"density": [R, S], "rgb": [R, S, 3]} and, with `predict_normals`,
    "pred_normals" [R, S, 3] from the `mlp_pred_normals` head.
    """

    def __init__(
        self,
        num_images: int,
        num_levels: int = 16,
        features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        hidden_dim_color: int = 64,
        num_layers_color: int = 3,
        appearance_embed_dim: int = 32,
        use_appearance_embedding: bool = True,
        sh_levels: int = 4,
        average_init_density: float = 1.0,
        encoding_backend: str = "factor",
        factor_features_per_level: int = 16,
        factor_num_levels: int = 8,
        predict_normals: bool = False,
        use_fused_density: bool = True,
    ):
        super().__init__()
        _check_backend(encoding_backend)
        self.encoding_backend = encoding_backend
        self.use_fused_density = use_fused_density
        self.predict_normals = predict_normals
        self.geo_feat_dim = geo_feat_dim
        self.sh_levels = sh_levels
        self.average_init_density = average_init_density
        self.appearance_embed_dim = appearance_embed_dim
        self.use_appearance_embedding = use_appearance_embedding
        if encoding_backend == "factor":
            self.encoding = FactorGridEncoding(
                FactorGridConfig(
                    num_levels=factor_num_levels,
                    base_res=base_res,
                    max_res=max_res,
                    features_per_level=factor_features_per_level,
                )
            )
            enc_dim = self.encoding.config.out_dim
        else:
            self.encoding = HashGridEncoding(num_levels, features_per_level, log2_hashmap_size, base_res, max_res)
            enc_dim = self.encoding.out_dim
        self.mlp_base = MLP(enc_dim, hidden_dim, 2, 1 + geo_feat_dim)
        head_in = sh_levels**2 + geo_feat_dim
        if use_appearance_embedding:
            head_in += appearance_embed_dim
            self.appearance = nn.Module()
            self.appearance.embedding = nn.Parameter(torch.empty(num_images, appearance_embed_dim))
        self.mlp_head = MLP(head_in, hidden_dim_color, num_layers_color, 3, "sigmoid")
        if predict_normals:
            self.mlp_pred_normals = MLP(geo_feat_dim + sh_levels**2, 64, 3, 3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoding.reset_parameters(generator)
        mlps = [self.mlp_base, self.mlp_head] + ([self.mlp_pred_normals] if self.predict_normals else [])
        for mlp in mlps:
            for layer in mlp.layers():
                layer.reset_parameters(generator)
        if self.use_appearance_embedding:
            with torch.no_grad():
                # Small codes keep the eval-time mean code in distribution.
                self.appearance.embedding.normal_(0.0, 0.01, generator=generator)

    def density(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions [..., 3] world -> (density [...], geo_feat [..., G])."""
        if self.encoding_backend == "factor" and self.use_fused_density:
            h = _density_logits(self.encoding, self.mlp_base, positions)
        else:
            h = self.mlp_base(self.encoding(contract_to_unit(positions)))
        density = self.average_init_density * trunc_exp(h[..., 0] - 1.0)
        return density, h[..., 1:]

    def forward(
        self,
        positions: torch.Tensor,  # [R, S, 3]
        directions: torch.Tensor,  # [R, 3]
        camera_indices: Optional[torch.Tensor] = None,  # [R] int
        train: bool = False,
        appearance_mode: Optional[str] = None,  # None (auto) | index | mean | zero
    ) -> Dict[str, torch.Tensor]:
        density, geo = self.density(positions)
        return self.head_only(density, geo, directions, camera_indices, train, appearance_mode)

    def head_only(
        self,
        density: torch.Tensor,  # [R, S]
        geo: torch.Tensor,  # [R, S, G]
        directions: torch.Tensor,  # [R, 3]
        camera_indices: Optional[torch.Tensor] = None,
        train: bool = False,
        appearance_mode: Optional[str] = None,
    ) -> Dict[str, torch.Tensor]:
        """The color and pred-normal heads over a precomputed (density, geo).

        Appearance code, as in the JAX package: "index" takes each ray's own
        image code, "mean" the mean of the codes (nerfstudio's eval rule),
        "zero" zeros; None means "index" when training with camera indices
        and "mean" otherwise. Pred normals are the head's output divided by
        max(|n|, 1e-6)."""
        d_enc = sh_encode(directions, self.sh_levels)
        d_enc = d_enc[..., None, :].expand(*density.shape, d_enc.shape[-1])
        head_in = [d_enc, geo]
        if self.use_appearance_embedding:
            if appearance_mode is None:
                appearance_mode = "index" if (train and camera_indices is not None) else "mean"
            codes = self.appearance.embedding
            if appearance_mode == "index" and camera_indices is not None:
                embed = codes[camera_indices.long()][..., None, :]
            elif appearance_mode == "zero":
                embed = codes.new_zeros(self.appearance_embed_dim)
            else:
                embed = codes.mean(0)
            head_in.append(embed.expand(*density.shape, self.appearance_embed_dim))
        rgb = self.mlp_head(torch.cat(head_in, dim=-1))
        out = {"density": density, "rgb": rgb}
        if self.predict_normals:
            pn = self.mlp_pred_normals(torch.cat([geo, d_enc], dim=-1))
            out["pred_normals"] = pn / pn.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        return out


def factor_density_geo_and_grad(
    field: NerfactoField,
    positions: torch.Tensor,  # [..., 3] world
    differentiable_grad: bool = False,
    xla: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(density [...], geo [..., G], d density / d x [..., 3]) with the
    spatial gradient in closed form: no autograd through the encode, so it
    also runs under `torch.inference_mode()`.

    Port of the JAX package's function of the same name. The chain: world x
    -> `contract_to_unit` (its Jacobian in closed form) -> the CP encode
    -> the base MLP (2 Dense + ReLU, bf16 contract) -> `trunc_exp`. With
    h0 the layer-0 output, the density channel's feature VJP row is
    g = bf16((1{h0 > 0} w1[:, 0]) @ w0^T) (bf16 operands, then f32), and
    s01 = d h1_0 / d pos01 [N, 3] is the encode's derivative contracted
    with g; d density / d x = density * (s01 @ J) * 1{|raw| < 15}.

    Two routes, one function:
    - the kernels (default): the encode through `encode_fused` (K3, K4 on
      the card) and s01 through `grad_encode_dot` (K5, K6); with
      ``differentiable_grad`` False, s01 is detached whole, so its g path
      into w0 and w1 is cut too (as the JAX fused branch does);
    - ``xla=True``: the JAX package's XLA hat/dhat expression (bf16 hat
      and slopes, bf16 products), the chain rule through d feat / d x and
      the MLP's forward mode in bf16; always differentiable, as in JAX.
    """
    cfg = field.encoding.config
    batch_shape = positions.shape[:-1]
    x = positions.reshape(-1, 3)
    pos01 = contract_to_unit(x)
    jac = contract_to_unit_jacobian(x)  # [N, 3 (pos01 j), 3 (world i)]
    lines = field.encoding.get_lines()
    (w0, b0), (w1, b1) = [layer.weights() for layer in field.mlp_base.layers()]
    if xla:
        levels = [cp_level_features_and_grad(pos01, lines[lvl]) for lvl in range(len(cfg.resolutions))]
        feat = torch.cat([f for f, _ in levels], dim=-1).float()
        dfeat01 = torch.cat([d for _, d in levels], dim=-1).float()  # [N, 3, D]
    else:
        feat = encode_fused(cfg, lines, pos01)
    h0 = dense_bf16(feat, w0, b0)
    h1 = dense_bf16(torch.relu(h0), w1, b1)  # [N, 1 + G]
    relu_mask = (h0 > 0).float()
    w0b, w1b = w0.to(torch.bfloat16).float(), w1.to(torch.bfloat16).float()
    if xla:
        dfeat_x = torch.einsum("njd,nji->nid", dfeat01, jac).to(torch.bfloat16).float()
        dh = (dfeat_x @ w0b).to(torch.bfloat16).float() * relu_mask[:, None, :]
        dh0 = (dh @ w1b).to(torch.bfloat16)[..., 0].float()  # [N, 3]
    else:
        g = ((relu_mask * w1b[:, 0]) @ w0b.T).to(torch.bfloat16).float()  # [N, D]
        s01 = grad_encode_dot(cfg, lines, pos01, g)
        if not differentiable_grad:
            s01 = s01.detach()
        dh0 = torch.einsum("nj,nji->ni", s01, jac)
    raw = h1[..., 0] - 1.0
    density = field.average_init_density * trunc_exp(raw)
    inside = ((raw > -15.0) & (raw < 15.0)).float()
    ddensity = density[..., None] * dh0 * inside[..., None]
    return (
        density.reshape(batch_shape),
        h1[..., 1:].reshape(*batch_shape, -1),
        ddensity.reshape(*batch_shape, 3),
    )


class HashMLPDensityField(nn.Module):
    """Small density-only field used as a proposal network: the factor grid
    `FactorGridEncoding_0` or the hash grid `HashGridEncoding_0`, then a
    2-layer `MLP_0`, or with `use_linear` (nerfstudio's linear proposal
    networks) a single bf16 `Dense_0` to one output, without an
    activation. The factor backend's encode + MLP is the fused
    `fused_density_mlp` (K1, K2) unless the field is linear or
    ``use_fused_density`` is False; then the features come from
    `FactorGridEncoding_0` (K3, K4 on the card)."""

    def __init__(
        self,
        num_levels: int = 5,
        features_per_level: int = 2,
        log2_hashmap_size: int = 17,
        base_res: int = 16,
        max_res: int = 128,
        hidden_dim: int = 16,
        use_linear: bool = False,
        encoding_backend: str = "factor",
        factor_features_per_level: int = 8,
        use_fused_density: bool = True,
    ):
        super().__init__()
        _check_backend(encoding_backend)
        self.encoding_backend = encoding_backend
        self.use_linear = use_linear
        self.use_fused_density = use_fused_density
        if encoding_backend == "factor":
            cfg = FactorGridConfig(
                num_levels=num_levels,
                base_res=base_res,
                max_res=max_res,
                features_per_level=factor_features_per_level,
            )
            self.FactorGridEncoding_0 = FactorGridEncoding(cfg)
        else:
            self.HashGridEncoding_0 = HashGridEncoding(
                num_levels, features_per_level, log2_hashmap_size, base_res, max_res
            )
        enc_dim = self.encoding.out_dim
        if use_linear:
            self.Dense_0 = Dense(enc_dim, 1)
        else:
            self.MLP_0 = MLP(enc_dim, hidden_dim, 2, 1)

    @property
    def encoding(self) -> nn.Module:
        return self.HashGridEncoding_0 if self.encoding_backend == "hash" else self.FactorGridEncoding_0

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoding.reset_parameters(generator)
        for layer in [self.Dense_0] if self.use_linear else self.MLP_0.layers():
            layer.reset_parameters(generator)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """positions [..., 3] world -> density [...]."""
        if self.encoding_backend == "factor" and self.use_fused_density and not self.use_linear:
            h = _density_logits(self.FactorGridEncoding_0, self.MLP_0, positions)
        else:
            feats = self.encoding(contract_to_unit(positions))
            h = self.Dense_0(feats) if self.use_linear else self.MLP_0(feats)
        return trunc_exp(h[..., 0] - 1.0)
