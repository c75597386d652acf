"""Nerfacto model: proposal sampling, the fields, volumetric rendering,
and its training losses.

Port of `signerf_tpu/models/nerfacto.py`, both encoding backends.
`NerfactoModel` is an `nn.Module` whose children `field`, `proposal_0` and
`proposal_1` (and the parameter `camera_opt` when it is on) carry the JAX
params tree's names. With `predict_normals` the base field also predicts
normals, and with `use_gradient_normals` the density's spatial gradient
gives the gradient normals, which the orientation and pred-normal losses
take at the reference's detach points: in closed form from
`fields.factor_density_geo_and_grad` (K3 to K6 on the card) with the factor
backend, by autograd through the hash encode with the hash backend.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from signerf_tpu_torch.cameras.camera_opt import apply_camera_opt, init_camera_opt
from signerf_tpu_torch.cameras.cameras import RayBundle
from signerf_tpu_torch.models import losses as L
from signerf_tpu_torch.models import renderers as R
from signerf_tpu_torch.models.fields import (
    HashMLPDensityField,
    NerfactoField,
    factor_density_geo_and_grad,
)
from signerf_tpu_torch.models.samplers import proposal_sample, render_weights


def density_geo_and_autograd(
    field: NerfactoField, positions: torch.Tensor, differentiable: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(density [...], geo [..., G], d density / d x [..., 3]) by autograd
    through the field's density: the same three components as the JAX
    package's three forward-mode JVPs, in one backward pass (each sample's
    density depends on its own position only). With `differentiable` the
    gradient keeps its graph (second order, for the orientation loss);
    otherwise it is detached. Under `torch.inference_mode()` (the eval
    render) the gradient is taken on a normal copy of the positions and
    the outputs come back detached."""
    with torch.inference_mode(False), torch.enable_grad():
        x = positions.clone() if positions.is_inference() else positions
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        density, geo = field.density(x)
        (grad,) = torch.autograd.grad(
            density, x, torch.ones_like(density), retain_graph=True, create_graph=differentiable
        )
    if positions.is_inference():
        density, geo = density.detach(), geo.detach()
    return density, geo, grad


@dataclasses.dataclass
class ProposalNetArgs:
    hidden_dim: int = 16
    log2_hashmap_size: int = 17
    num_levels: int = 5
    max_res: int = 128
    use_linear: bool = False  # nerfstudio's linear proposal networks: one Dense, no MLP


@dataclasses.dataclass
class NerfactoModelConfig:
    """The knobs of the JAX package's `NerfactoModelConfig` that the forward
    and the training losses read, with the same names and defaults.
    `num_levels`, `features_per_level` and `log2_hashmap_size` (and the
    proposal args' `log2_hashmap_size`) size the hash grid; the factor grid
    keeps the fields' own level counts."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    appearance_embed_dim: int = 32
    use_appearance_embedding: bool = True
    average_init_density: float = 1.0
    encoding_backend: str = "factor"  # "factor" or "hash"
    # The JAX debug switch: False runs the factor fields' density as the
    # encoding module, then the MLP, instead of the fused K1 / K2 path.
    use_fused_density: bool = True
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[ProposalNetArgs, ...] = (
        ProposalNetArgs(max_res=128),
        ProposalNetArgs(max_res=256),
    )
    single_jitter: bool = True
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    predict_normals: bool = False
    use_gradient_normals: bool = True  # only active when predict_normals
    # The JAX package's deviation from nerfstudio (off by default): gradient
    # normals detached at creation, the orientation penalty on the pred
    # normals instead. False keeps the reference's semantics: the
    # orientation loss takes the gradient normals undetached, the
    # pred-normal loss detached.
    fast_normals_losses: bool = False
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    orientation_loss_mult: float = 0.0001
    pred_normal_loss_mult: float = 0.001
    use_camera_opt: bool = False
    eval_num_rays_per_chunk: int = 1 << 15  # full-frame renders: chunks of at most this many rays


class NerfactoModel(nn.Module):
    """Nerfacto over an explicit ray batch; parameters live in the module."""

    def __init__(self, config: NerfactoModelConfig, num_train_images: int):
        super().__init__()
        self.config = config
        self.num_train_images = num_train_images
        self.field = NerfactoField(
            num_images=num_train_images,
            num_levels=config.num_levels,
            features_per_level=config.features_per_level,
            log2_hashmap_size=config.log2_hashmap_size,
            base_res=config.base_res,
            max_res=config.max_res,
            hidden_dim=config.hidden_dim,
            hidden_dim_color=config.hidden_dim_color,
            appearance_embed_dim=config.appearance_embed_dim,
            use_appearance_embedding=config.use_appearance_embedding,
            average_init_density=config.average_init_density,
            encoding_backend=config.encoding_backend,
            predict_normals=config.predict_normals,
            use_fused_density=config.use_fused_density,
        )
        n_fields = 1 if config.use_same_proposal_network else config.num_proposal_iterations
        for i in range(n_fields):
            args = config.proposal_net_args_list[min(i, len(config.proposal_net_args_list) - 1)]
            self.add_module(
                f"proposal_{i}",
                HashMLPDensityField(
                    num_levels=args.num_levels,
                    log2_hashmap_size=args.log2_hashmap_size,
                    max_res=args.max_res,
                    hidden_dim=args.hidden_dim,
                    use_linear=args.use_linear,
                    encoding_backend=config.encoding_backend,
                    use_fused_density=config.use_fused_density,
                ),
            )
        if config.use_camera_opt:
            self.camera_opt = nn.Parameter(init_camera_opt(num_train_images))

    def reset_parameters(self, generator: torch.Generator) -> "NerfactoModel":
        """Fresh random parameters drawn from `generator` (seeded init)."""
        for child in self.children():
            child.reset_parameters(generator)
        if self.config.use_camera_opt:
            with torch.no_grad():
                self.camera_opt.zero_()
        return self

    def density_fns(self):
        cfg = self.config
        return [
            getattr(self, f"proposal_{0 if cfg.use_same_proposal_network else i}")
            for i in range(cfg.num_proposal_iterations)
        ]

    def anneal(self, step: int) -> float:
        """Proposal-weight annealing exponent for `step`, in [0, 1]."""
        # f32 arithmetic, as the JAX package computes it
        n = self.config.proposal_weights_anneal_max_num_iters
        x = (torch.tensor(float(step)) / n).clamp(0.0, 1.0)
        b = self.config.proposal_weights_anneal_slope
        return float(b * x / ((b - 1.0) * x + 1.0))

    def forward(
        self,
        ray_bundle: RayBundle,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        anneal: float = 1.0,
        appearance_mode: Optional[str] = None,  # None (auto) | index | mean | zero
    ) -> Dict[str, Any]:
        """Forward pass over a flat ray batch [R]; `generator=None` is the
        deterministic sampling. Training applies the camera pose correction
        when it is on and, by default, each ray's own appearance code."""
        cfg = self.config
        origins = ray_bundle.origins
        directions = ray_bundle.directions
        cam_idx = None if ray_bundle.camera_indices is None else ray_bundle.camera_indices[..., 0]
        if cfg.use_camera_opt and train and cam_idx is not None:
            origins, directions = apply_camera_opt(self.camera_opt, origins, directions, cam_idx)
        num_rays = origins.shape[0]
        nears = ray_bundle.nears
        if nears is None:
            nears = torch.full((num_rays, 1), cfg.near_plane, dtype=origins.dtype, device=origins.device)
        fars = ray_bundle.fars
        if fars is None:
            fars = torch.full((num_rays, 1), cfg.far_plane, dtype=origins.dtype, device=origins.device)
        bundle = RayBundle(
            origins=origins,
            directions=directions,
            pixel_area=ray_bundle.pixel_area,
            camera_indices=ray_bundle.camera_indices,
            nears=nears.clamp_min(cfg.near_plane),
            fars=fars.clamp_max(cfg.far_plane),
        )
        samples, weights_list, samples_list = proposal_sample(
            generator,
            bundle,
            self.density_fns(),
            num_proposal_samples=cfg.num_proposal_samples_per_ray,
            num_nerf_samples=cfg.num_nerf_samples_per_ray,
            single_jitter=cfg.single_jitter,
            anneal=anneal,
        )
        grad = None
        if cfg.predict_normals and cfg.use_gradient_normals:
            # The density's spatial gradient, sharing the primal; the
            # reference's orientation loss backprops through it into the
            # field, so it stays differentiable while training.
            differentiable = train and not cfg.fast_normals_losses
            if cfg.encoding_backend == "factor":
                density, geo, grad = factor_density_geo_and_grad(
                    self.field, samples.positions, differentiable_grad=differentiable
                )
            else:
                density, geo, grad = density_geo_and_autograd(self.field, samples.positions, differentiable)
            field_out = self.field.head_only(density, geo, directions, cam_idx, train, appearance_mode)
        else:
            field_out = self.field(samples.positions, directions, cam_idx, train, appearance_mode)
        weights = render_weights(field_out["density"], samples.deltas)
        outputs = {
            "rgb": R.render_rgb(weights, field_out["rgb"], cfg.background_color),
            "accumulation": R.render_accumulation(weights),
            "depth": R.render_depth_median(weights, samples.starts, samples.ends),
            "expected_depth": R.render_depth_expected(weights, samples.starts, samples.ends),
            "weights": weights,
            "ray_samples": samples,
            "weights_list": weights_list,
            "ray_samples_list": samples_list,
            "directions": bundle.directions,
        }
        if cfg.predict_normals:
            outputs["pred_normals_samples"] = field_out["pred_normals"]
            outputs["pred_normals"] = R.render_normals(weights, field_out["pred_normals"])
            if grad is not None:
                if cfg.fast_normals_losses:
                    grad = grad.detach()
                # sqrt(|g|^2 + eps) keeps the value finite at grad = 0
                n = -grad / torch.sqrt((grad * grad).sum(-1, keepdim=True) + 1e-12)
                outputs["normals_samples"] = n
                outputs["normals"] = R.render_normals(weights, n)
        return outputs

    def loss_dict(
        self, outputs: Dict[str, Any], batch: Dict[str, torch.Tensor], train: bool = True
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        loss = {"rgb_loss": L.mse_loss(outputs["rgb"], batch["image"])}
        if train:
            loss["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
                outputs["weights_list"],
                outputs["ray_samples_list"],
                outputs["weights"],
                outputs["ray_samples"],
            )
            loss["distortion_loss"] = cfg.distortion_loss_mult * L.distortion_loss(
                outputs["weights"], outputs["ray_samples"]
            )
            if cfg.predict_normals and "normals_samples" in outputs:
                loss.update(self.normals_losses(outputs))
        return loss

    def normals_losses(self, outputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Orientation and pred-normal losses at the reference's detach
        points (nerfstudio 1.0.2, inherited by SIGNeRF): both take detached
        weights; the orientation loss takes the gradient normals undetached
        (it trains the density field), the pred-normal loss detached (it
        trains only the head). Under `fast_normals_losses` the gradient
        normals were detached at creation and the orientation loss takes
        the pred normals instead."""
        cfg = self.config
        w = outputs["weights"].detach()
        orient = outputs["pred_normals_samples"] if cfg.fast_normals_losses else outputs["normals_samples"]
        return {
            "orientation_loss": cfg.orientation_loss_mult
            * L.orientation_loss(w, orient, outputs["directions"]),
            "pred_normal_loss": cfg.pred_normal_loss_mult
            * L.pred_normal_loss(w, outputs["normals_samples"].detach(), outputs["pred_normals_samples"]),
        }

    def metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        return {"psnr": L.psnr(outputs["rgb"], batch["image"])}
