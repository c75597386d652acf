"""Ray/primitive intersection (slab AABB test, quadratic sphere test).

Port of `signerf_tpu/ops/intersection.py`. Shape-polymorphic over leading
batch dims.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def intersect_with_aabb(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection; aabb [2, 3] = (min_xyz, max_xyz).

    Returns unclamped (nears, fars), each [..., 1]; nears > fars means no hit.
    """
    aabb = torch.as_tensor(aabb, dtype=rays_o.dtype, device=rays_o.device)
    inv_d = 1.0 / (rays_d + 1e-6)  # the reference's epsilon convention
    t_lo = (aabb[0] - rays_o) * inv_d
    t_hi = (aabb[1] - rays_o) * inv_d
    nears = torch.minimum(t_lo, t_hi).amax(dim=-1, keepdim=True)
    fars = torch.maximum(t_lo, t_hi).amin(dim=-1, keepdim=True)
    return nears, fars


def intersect_with_sphere(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    center: Sequence[float] | torch.Tensor,
    radius: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic ray/sphere intersection for unit directions.

    Non-hits collapse to the ray-perpendicular foot point; near/far are
    clamped to >= 0.
    """
    center = torch.as_tensor(center, dtype=rays_o.dtype, device=rays_o.device)
    oc = rays_o - center
    b = (oc * rays_d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - c
    roots = torch.where(disc > 0, disc.clamp_min(0.0).sqrt(), torch.zeros_like(disc))
    t1 = -b - roots
    t2 = -b + roots
    nears = torch.minimum(t1, t2).clamp_min(0.0)[..., None]
    fars = torch.maximum(t1, t2).clamp_min(0.0)[..., None]
    return nears, fars
