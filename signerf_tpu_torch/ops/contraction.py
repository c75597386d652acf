"""Scene contraction (mipnerf360-style, L-inf norm) into [-2, 2]^3.

Port of `signerf_tpu/ops/contraction.py`.
"""

from __future__ import annotations

import math

import torch


def contract(positions: torch.Tensor, order: float = math.inf) -> torch.Tensor:
    """Map R^3 -> ball of radius 2: x if |x| <= 1 else (2 - 1/|x|) * x/|x|.

    `mag_safe` clamps the scaled branch's input to >= 1, so both branches
    stay finite everywhere (the reference needs that for its gradients).
    """
    if order == math.inf:
        mag = positions.abs().amax(dim=-1, keepdim=True)
        mag_safe = mag.clamp_min(1.0)
        # Same operation order as the reference's L-inf path: one per-point
        # scale, then three products.
        s = (2.0 - 1.0 / mag_safe) / mag_safe
        s = torch.where(mag <= 1.0, torch.ones_like(s), s)
        return positions * s
    mag = torch.linalg.vector_norm(positions, ord=order, dim=-1, keepdim=True)
    mag_safe = mag.clamp_min(1.0)
    scaled = (2.0 - 1.0 / mag_safe) * (positions / mag_safe)
    return torch.where(mag <= 1.0, positions, scaled)


def contract_to_unit(positions: torch.Tensor, order: float = math.inf) -> torch.Tensor:
    """Contract and shift into [0, 1]^3 for the grid lookup ((x + 2) / 4)."""
    return (contract(positions, order) + 2.0) / 4.0
