"""Ray-traced proxy-mesh depth rendering (Möller–Trumbore, tiled).

Port of `signerf_tpu/geometry/raster.py`: every ray of a camera is tested
against every triangle of the posed mesh, tiled over (ray chunk x triangle
chunk) with a running min of the hit distance, on the device of the
camera, so the occlusion test against the NeRF's depth never leaves it.

The JAX conventions hold: depth is the euclidean distance along the ray
(not GL z-buffer depth), 0 on a miss, and hits outside [znear, zfar] are
discarded; the colour is flat on a hit and white elsewhere. The ray and
triangle counts are padded to whole chunks as the JAX version pads them:
padding rays start at the origin with direction (1, 1, 1), padding
triangles are degenerate (zero area at the origin) and never hit.

Plain PyTorch (no kernel of its own: the JAX version is XLA, not Pallas).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _moller_trumbore(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    v0: torch.Tensor,  # [T, 3]
    e1: torch.Tensor,  # [T, 3]
    e2: torch.Tensor,  # [T, 3]
) -> torch.Tensor:
    """Min hit distance per ray over T triangles, +inf on a miss -> [N]."""
    eps = 1e-8
    h = torch.linalg.cross(rays_d[:, None, :], e2[None, :, :])  # [N, T, 3]
    a = (e1[None] * h).sum(-1)
    parallel = a.abs() < eps
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = rays_o[:, None, :] - v0[None, :, :]
    u = f * (s * h).sum(-1)
    q = torch.linalg.cross(s, e1[None, :, :].expand_as(s))
    v = f * (rays_d[:, None, :] * q).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    valid = ~parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(valid, t, torch.full_like(t, float("inf"))).amin(-1)


def _pad_rows(x: torch.Tensor, multiple: int, value: float) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x.new_full((pad, 3), value)]) if pad else x


def ray_mesh_depth(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    verts,  # [V, 3], already posed in world space
    faces,  # [T, 3] int
    tri_chunk: int = 512,
    ray_chunk: int = 4096,
) -> torch.Tensor:
    """Min hit distance per ray, +inf on a miss -> [N], on the rays' device."""
    dev, dt = rays_o.device, rays_o.dtype
    verts = torch.as_tensor(verts, dtype=dt, device=dev)
    faces = torch.as_tensor(faces, device=dev).long()
    v0 = verts[faces[:, 0]]
    e1 = _pad_rows(verts[faces[:, 1]] - v0, tri_chunk, 0.0)
    e2 = _pad_rows(verts[faces[:, 2]] - v0, tri_chunk, 0.0)
    v0 = _pad_rows(v0, tri_chunk, 0.0)
    num_rays = rays_o.shape[0]
    ro = _pad_rows(rays_o, ray_chunk, 0.0)
    rd = _pad_rows(rays_d, ray_chunk, 1.0)
    out = []
    for r in range(0, ro.shape[0], ray_chunk):
        t_min = torch.full((ray_chunk,), float("inf"), dtype=dt, device=dev)
        for k in range(0, v0.shape[0], tri_chunk):
            t = _moller_trumbore(ro[r : r + ray_chunk], rd[r : r + ray_chunk], v0[k : k + tri_chunk],
                                 e1[k : k + tri_chunk], e2[k : k + tri_chunk])
            t_min = torch.minimum(t_min, t)
        out.append(t_min)
    return torch.cat(out)[:num_rays]


def mesh_depth_render(
    camera,
    verts,
    faces,
    znear: float = 1e-4,
    zfar: float = 10.0,
    color: Optional[Tuple[float, float, float]] = (0.0, 0.0, 0.0),
    camera_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(colour [H, W, 3], depth [H, W, 1]) of a posed mesh seen from camera
    `camera_index` of `camera` (a `Cameras`), on the camera's device:
    depth 0 where the mesh is not hit or the hit lies outside [znear,
    zfar], colour `color` on hits and white elsewhere."""
    rb = camera.generate_rays(camera_index=camera_index)
    h, w = rb.origins.shape[:2]
    t = ray_mesh_depth(rb.origins.reshape(-1, 3), rb.directions.reshape(-1, 3), verts, faces).reshape(h, w)
    hit = torch.isfinite(t) & (t >= znear) & (t <= zfar)
    depth = torch.where(hit, t, torch.zeros_like(t))[..., None]
    col = torch.as_tensor(color, dtype=torch.float32, device=t.device).expand(h, w, 3)
    color_img = torch.where(hit[..., None], col, torch.ones_like(col))
    return color_img, depth
