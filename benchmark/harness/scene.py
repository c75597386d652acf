"""The benchmark's scene: an analytic shaded sphere seen from a ring of
cameras, rendered on the device.

A frozen copy of the synthetic scene of `chip_smoke.py` and
`examples/north_star_pass_torch.py` (a sphere shaded by |hit point| /
radius before a direction-dependent backdrop, cameras on a ring looking at
its centre), placed as the dataparser would place it: the cameras at
radius 1 from the origin, the sphere of radius 1/3 inside the unit box.
Every seed sees the same scene: what the seed changes is the weights and
the sampler's draws, never the sizes or the amount of work.
"""

from __future__ import annotations

import math

import torch

CAMERA_RADIUS = 1.0
SPHERE_RADIUS = 1.0 / 3.0
FOCAL_PER_PX = 1200.0 / 1024


def look_at(positions: torch.Tensor) -> torch.Tensor:
    """[N, 3] camera centres -> [N, 3, 4] camera-to-world (OpenGL: the
    camera looks along -z at the origin, z up in the world)."""
    z = positions / positions.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=positions.device).expand_as(z)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z, positions], dim=-1)


def ring_poses(n: int, theta_deg: float, device, radius: float = CAMERA_RADIUS) -> torch.Tensor:
    """`n` poses evenly on a circle at polar angle `theta_deg`, from azimuth 0."""
    phis = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
    th = math.radians(theta_deg)
    pos = torch.stack([radius * math.sin(th) * torch.cos(phis), radius * math.sin(th) * torch.sin(phis),
                       torch.full_like(phis, radius * math.cos(th))], dim=-1)
    return look_at(pos.float().to(device))


def pixel_rays(c2w: torch.Tensor, focal: float, width: int, height: int):
    """One camera's rays at the pixel centres: origins and unit directions
    [H, W, 3] (x right, y down in the image; the camera frame's direction
    is [(u - cx) / f, -(v - cy) / f, -1])."""
    dev = c2w.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([(px - width / 2) / focal, -(py - height / 2) / focal, -torch.ones_like(px)], -1)
    d = d_cam @ c2w[:, :3].T
    d = d / d.norm(dim=-1, keepdim=True)
    return c2w[:, 3].expand_as(d), d


def analytic_rgb(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - SPHERE_RADIUS**2
    disc = b * b - c
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    p = o + d * t[..., None]
    hit = (disc > 0)[..., None]
    return torch.where(hit, (p.abs() / SPHERE_RADIUS).clamp(0.0, 1.0), (0.55 + 0.3 * d).clamp(0.0, 1.0))


def make_views(n: int, size: int, device, theta_deg: float = 60.0):
    """(poses [n, 3, 4], focal, images [n, size, size, 3] uint8) on `device`."""
    poses = ring_poses(n, theta_deg, device)
    focal = FOCAL_PER_PX * size
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        o, d = pixel_rays(poses[i], focal, size, size)
        images[i] = (analytic_rgb(o, d) * 255.0 + 0.5).to(torch.uint8)
    return poses, focal, images
