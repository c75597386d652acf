"""Look-at camera poses on a circle and on a sphere cap.

Port of `circle_poses` and `random_sphere_poses` from
`signerf_tpu/cameras/poses.py`: z-up world; the camera's +z points from the
target to the camera (the OpenGL camera looks along -z, so it faces the
target), x = normalize(z_up x z), y = z x x.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """`jnp.linspace`'s float32 rule, both ends included: start * (1 - i / n)
    + stop * (i / n) for i < n = num - 1, then stop. `torch.linspace` steps
    from the nearer end instead, which moves interior points by an ulp."""
    if num <= 1:
        return torch.full((num,), start, dtype=torch.float32)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    lo, hi = torch.tensor(start, dtype=torch.float32), torch.tensor(stop, dtype=torch.float32)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


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
    phis = linspace_f32(math.radians(phi[0]), math.radians(phi[1]), size)
    positions = torch.stack(
        [
            radius * math.sin(th) * torch.cos(phis) + position[0],
            radius * math.sin(th) * torch.sin(phis) + position[1],
            radius * math.cos(th) * torch.ones_like(phis) + position[2],
        ],
        dim=-1,
    )
    return look_at_poses(positions, target)


def random_sphere_poses(
    size: int,
    radius: float,
    theta: Tuple[float, float],
    phi: Tuple[float, float],
    position: Sequence[float] = (0.0, 0.0, 0.0),
    target: Sequence[float] = (0.0, 0.0, 0.0),
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """`size` random look-at poses on a sphere cap, uniform in cos(theta):
    theta = (min, max) polar angles from +z and phi = (start, end) azimuths,
    in degrees. The two uniform [0, 1) draws of `size` values each (theta's,
    then phi's) come from `generator`, or are given as `uniforms`."""
    if uniforms is None:
        uniforms = (torch.rand(size, generator=generator), torch.rand(size, generator=generator))
    u_theta, u_phi = (torch.as_tensor(u, dtype=torch.float32).reshape(size) for u in uniforms)
    t_min = (1.0 - math.cos(math.radians(theta[0]))) * 0.5
    t_max = (1.0 - math.cos(math.radians(theta[1]))) * 0.5
    thetas = torch.arccos(1.0 - 2.0 * (u_theta * (t_max - t_min) + t_min))
    phis = u_phi * (math.radians(phi[1]) - math.radians(phi[0])) + math.radians(phi[0])
    pos = torch.as_tensor(position, dtype=torch.float32)
    positions = torch.stack(
        [
            radius * torch.sin(thetas) * torch.cos(phis) + pos[0],
            radius * torch.sin(thetas) * torch.sin(phis) + pos[1],
            radius * torch.cos(thetas) + pos[2],
        ],
        dim=-1,
    )
    return look_at_poses(positions, target)
