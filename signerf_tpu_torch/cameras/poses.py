"""Look-at camera poses on a circle.

Port of `circle_poses` from `signerf_tpu/cameras/poses.py`: z-up world; the
camera's +z points from the target to the camera (the OpenGL camera looks
along -z, so it faces the target), x = normalize(z_up x z), y = z x x.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / (x * x).sum(-1, keepdim=True).clamp_min(eps).sqrt()


def look_at_poses(positions: torch.Tensor, target: Sequence[float]) -> torch.Tensor:
    """[N, 4, 4] camera-to-world matrices at `positions` looking at `target`."""
    target_v = torch.as_tensor(target, dtype=torch.float32, device=positions.device)
    z = safe_normalize(positions - target_v)
    up = torch.tensor([0.0, 0.0, 1.0], device=positions.device).expand(z.shape)
    x = safe_normalize(torch.linalg.cross(up, z, dim=-1))
    y = safe_normalize(torch.linalg.cross(z, x, dim=-1))
    poses = torch.eye(4, device=positions.device).repeat(positions.shape[0], 1, 1)
    poses[:, :3, 0] = x
    poses[:, :3, 1] = y
    poses[:, :3, 2] = z
    poses[:, :3, 3] = positions
    return poses


def circle_poses(
    size: int,
    radius: float,
    theta: float,
    phi: Tuple[float, float],
    position: Sequence[float] = (0.0, 0.0, 0.0),
    target: Sequence[float] = (0.0, 0.0, 0.0),
) -> torch.Tensor:
    """`size` look-at poses on a circle: theta is the polar angle from +z in
    degrees; phi = (start, end) azimuths in degrees, both included."""
    th = math.radians(theta)
    phis = torch.linspace(math.radians(phi[0]), math.radians(phi[1]), size)
    positions = torch.stack(
        [
            radius * math.sin(th) * torch.cos(phis) + position[0],
            radius * math.sin(th) * torch.sin(phis) + position[1],
            radius * math.cos(th) * torch.ones_like(phis) + position[2],
        ],
        dim=-1,
    )
    return look_at_poses(positions, target)
