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


def _tie_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d max(a, b) / da as JAX's `max` takes it: 1, 0, or 0.5 on a tie."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def contract_to_unit_jacobian(positions: torch.Tensor) -> torch.Tensor:
    """d contract_to_unit(x) / dx of the L-inf contraction in closed form:
    [N, 3] -> [N, 3 (pos01 j), 3 (world i)].

    Inside the unit cube the map is x / 4 + 1/2, so J = I / 4. Outside it
    is x s(m) with m = max_i |x_i| and s = (2 - 1/m) / m, so
    J = (s I + s'(m) x (dm/dx)^T) / 4 with s' = 2 / m^3 - 2 / m^2 and
    dm/dx_i = sign(x_i) on the maximal axis. Where two or three |x_i| tie
    for the max, dm/dx follows the JAX package's `max(max(|x|, |y|), |z|)`:
    an exact tie splits 1/2 and 1/2 at each of the two maxima (so a
    three-way tie weighs 1/4, 1/4, 1/2), as `jax.jvp` does. At m = 1 the
    inside branch applies, with J = I / 4. No autograd is involved, so it
    works under `torch.inference_mode()`.
    """
    a = positions.abs()
    ax, ay, az = a.unbind(-1)
    wx1 = _tie_split(ax, ay)
    m1 = torch.maximum(ax, ay)
    wm = _tie_split(m1, az)
    sign = torch.sign(positions)
    dmag = torch.stack([wm * wx1 * sign[..., 0], wm * (1.0 - wx1) * sign[..., 1],
                        (1.0 - wm) * sign[..., 2]], dim=-1)
    mag = torch.maximum(m1, az)[..., None]
    mag_safe = mag.clamp_min(1.0)
    s = (2.0 - 1.0 / mag_safe) / mag_safe
    ds = 2.0 / mag_safe**3 - 2.0 / mag_safe**2
    eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
    outside = s[..., None] * eye + (ds * positions)[..., :, None] * dmag[..., None, :]
    return torch.where((mag <= 1.0)[..., None], eye, outside) / 4.0
