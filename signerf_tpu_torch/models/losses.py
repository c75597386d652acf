"""NeRF training losses: interlevel (proposal), distortion, normals and
pixel losses.

Port of `signerf_tpu/models/losses.py` (mipnerf360 and Ref-NeRF as
implemented in nerfstudio). The proposal losses work in normalized s-space
on [R, S] tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

from signerf_tpu_torch.models.ray_samples import RaySamples

EPS = 1e-7


def _outer(
    t0_starts: torch.Tensor,
    t0_ends: torch.Tensor,
    t1_starts: torch.Tensor,
    t1_ends: torch.Tensor,
    y1: torch.Tensor,
) -> torch.Tensor:
    """For each interval [t0_s, t0_e], the y1 mass of the overlapping t1
    bins (outer-measure upper bound, mipnerf360 eq. 13).

    The same masked max/min reductions as the JAX package: `amax`/`amin`
    split the gradient evenly between tied entries, as JAX's max and min
    do, so the proposal gradients agree where the cumulative sum is flat.
    """
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), y1.cumsum(-1)], dim=-1)  # [R, S1+1]
    inf = torch.tensor(float("inf"), dtype=cy1.dtype, device=cy1.device)
    le = t1_starts[..., None, :] <= t0_starts[..., :, None]  # [R, S0, S1]
    ge = t1_ends[..., None, :] >= t0_ends[..., :, None]
    cy1_lo = torch.where(le, cy1[..., None, :-1], -inf).amax(-1)
    cy1_hi = torch.where(ge, cy1[..., None, 1:], inf).amin(-1)
    # clip semantics of the searchsorted formulation at the boundaries
    cy1_lo = torch.where(torch.isfinite(cy1_lo), cy1_lo, cy1[..., :1])
    cy1_hi = torch.where(torch.isfinite(cy1_hi), cy1_hi, cy1[..., -1:])
    return cy1_hi - cy1_lo


def lossfun_outer(
    t: torch.Tensor,  # [R, S+1] final bins (s-space)
    w: torch.Tensor,  # [R, S] final weights (detached by the caller)
    t_env: torch.Tensor,  # [R, S1+1] proposal bins
    w_env: torch.Tensor,  # [R, S1] proposal weights (grads flow)
) -> torch.Tensor:
    w_outer = _outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return (w - w_outer).clamp_min(0.0) ** 2 / (w + EPS)


def interlevel_loss(
    weights_list: Sequence[torch.Tensor],
    ray_samples_list: Sequence[RaySamples],
    final_weights: torch.Tensor,
    final_samples: RaySamples,
) -> torch.Tensor:
    """Proposal supervision: pull each proposal histogram over the field's."""
    c = final_samples.spacing_bins.detach()
    w = final_weights.detach()
    loss = 0.0
    for w_prop, s_prop in zip(weights_list, ray_samples_list):
        loss = loss + lossfun_outer(c, w, s_prop.spacing_bins, w_prop).sum(-1).mean()
    return loss


def distortion_loss(final_weights: torch.Tensor, final_samples: RaySamples) -> torch.Tensor:
    """mipnerf360 distortion in s-space (O(S^2))."""
    t = final_samples.spacing_bins  # [R, S+1]
    w = final_weights  # [R, S]
    ut = 0.5 * (t[..., 1:] + t[..., :-1])
    dut = (ut[..., :, None] - ut[..., None, :]).abs()  # [R, S, S]
    loss_inter = (w * (w[..., None, :] * dut).sum(-1)).sum(-1)
    loss_intra = (w**2 * (t[..., 1:] - t[..., :-1])).sum(-1) / 3.0
    return (loss_inter + loss_intra).mean()


def orientation_loss(
    weights: torch.Tensor,  # [R, S]
    normals: torch.Tensor,  # [R, S, 3]
    view_dirs: torch.Tensor,  # [R, 3]
) -> torch.Tensor:
    """Penalize normals facing away from the camera (Ref-NeRF)."""
    n_dot_v = (normals * -view_dirs[:, None, :]).sum(-1)  # [R, S]
    return (weights * n_dot_v.clamp_max(0.0) ** 2).sum(-1).mean()


def pred_normal_loss(
    weights: torch.Tensor,  # [R, S]
    normals: torch.Tensor,  # [R, S, 3] gradient normals, detached by the caller
    pred_normals: torch.Tensor,  # [R, S, 3]
) -> torch.Tensor:
    return (weights * (1.0 - (normals * pred_normals).sum(-1))).sum(-1).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse_loss(pred, target).clamp_min(1e-12))
