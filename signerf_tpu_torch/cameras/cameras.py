"""Pinhole cameras with OpenCV distortion, and ray generation.

Port of `signerf_tpu/cameras/cameras.py`. Conventions (nerfstudio's):
world z-up and right-handed; camera-to-world OpenGL style (x right, y up,
looking along -z); image x right, y down, pixel centers at +0.5; camera-frame
ray direction [(u - cx) / fx, -(v - cy) / fy, -1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from signerf_tpu_torch.ops.intersection import intersect_with_aabb


@dataclasses.dataclass
class RayBundle:
    """A batch of rays. All leading dims are arbitrary batch dims."""

    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3] unit-norm
    pixel_area: torch.Tensor  # [..., 1]
    camera_indices: torch.Tensor  # [..., 1] int32
    nears: Optional[torch.Tensor] = None  # [..., 1]
    fars: Optional[torch.Tensor] = None  # [..., 1]

    @property
    def shape(self) -> torch.Size:
        return self.origins.shape[:-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RayBundle":
        """Apply `fn` to every tensor field (None stays None)."""
        return RayBundle(
            **{
                f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
            }
        )

    def reshape(self, shape) -> "RayBundle":
        return self.map(lambda x: x.reshape(tuple(shape) + (x.shape[-1],)))


def _undistort_newton(
    u: torch.Tensor,
    v: torch.Tensor,
    dist: torch.Tensor,
    num_iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the OpenCV radial/tangential distortion by a fixed number of
    2x2 Newton steps. ``dist`` = [..., 6] = k1, k2, k3, k4, p1, p2::

        r2 = x^2 + y^2
        d  = 1 + k1 r2 + k2 r2^2 + k3 r2^3 + k4 r2^4
        u  = x d + 2 p1 x y + p2 (r2 + 2 x^2)
        v  = y d + p1 (r2 + 2 y^2) + 2 p2 x y
    """
    k1, k2, k3, k4, p1, p2 = (dist[..., i] for i in range(6))
    x, y = u, v
    for _ in range(num_iters):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fu = x * d + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - u
        fv = y * d + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - v
        d_r2 = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * 4.0 * k4))
        fu_x = d + 2.0 * x * x * d_r2 + 2.0 * p1 * y + 6.0 * p2 * x
        fu_y = 2.0 * x * y * d_r2 + 2.0 * p1 * x + 2.0 * p2 * y
        fv_x = 2.0 * x * y * d_r2 + 2.0 * p1 * x + 2.0 * p2 * y
        fv_y = d + 2.0 * y * y * d_r2 + 6.0 * p1 * y + 2.0 * p2 * x
        det = fu_x * fv_y - fu_y * fv_x
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (fu * fv_y - fv * fu_y) / det
        dy = (fv * fu_x - fu * fv_x) / det
        x, y = x - dx, y - dy
    return x, y


@dataclasses.dataclass
class Cameras:
    """Batched pinhole cameras; leading dim = number of cameras."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N]
    fy: torch.Tensor  # [N]
    cx: torch.Tensor  # [N]
    cy: torch.Tensor  # [N]
    distortion_params: Optional[torch.Tensor] = None  # [N, 6] k1..k4, p1, p2
    width: int = 0
    height: int = 0

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.camera_to_worlds.device

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self,
            **{
                name: getattr(self, name).to(device)
                for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "distortion_params")
                if getattr(self, name) is not None
            },
        )

    def rescaled(self, scale: float) -> "Cameras":
        """Rescale the output resolution (nerfstudio `rescale_output_resolution`)."""
        return dataclasses.replace(
            self,
            fx=self.fx * scale,
            fy=self.fy * scale,
            cx=self.cx * scale,
            cy=self.cy * scale,
            width=int(round(self.width * scale)),
            height=int(round(self.height * scale)),
        )

    def _pixel_to_directions(
        self, cam_idx: torch.Tensor, px: torch.Tensor, py: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World directions [..., 3] and pixel areas [..., 1] for pixel
        centers (px, py) of cameras cam_idx."""
        fx = self.fx[cam_idx]
        fy = self.fy[cam_idx]
        u = (px - self.cx[cam_idx]) / fx
        v = (py - self.cy[cam_idx]) / fy
        if self.distortion_params is not None:
            u, v = _undistort_newton(u, v, self.distortion_params[cam_idx])
        dirs_cam = torch.stack([u, -v, -torch.ones_like(u)], dim=-1)
        rot = self.camera_to_worlds[cam_idx][..., :3, :3]
        dirs_world = (rot * dirs_cam[..., None, :]).sum(-1)
        norm = torch.linalg.vector_norm(dirs_world, dim=-1, keepdim=True)
        dirs_world = dirs_world / norm.clamp_min(1e-12)
        pixel_area = (1.0 / (fx * fy)) / norm.squeeze(-1) ** 2
        return dirs_world, pixel_area[..., None]

    def generate_rays(
        self, camera_index: int = 0, aabb: Optional[torch.Tensor] = None
    ) -> RayBundle:
        """Full-image ray bundle [H, W] for one camera, clipped to `aabb`
        ([2, 3]) when given."""
        h, w = self.height, self.width
        dev = self.device
        ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        cam_idx = torch.full((h, w), camera_index, dtype=torch.long, device=dev)
        return self._rays_from_pixels(cam_idx, px, py, aabb)

    def generate_rays_at(
        self, indices: torch.Tensor, aabb: Optional[torch.Tensor] = None
    ) -> RayBundle:
        """Rays for sampled pixels: indices [N, 3] int = (camera, y, x), at
        the pixel centers. The train step passes no aabb, so its rays get
        the model's near/far planes instead of the scene box."""
        cam_idx = indices[..., 0].long()
        py = indices[..., 1].float() + 0.5
        px = indices[..., 2].float() + 0.5
        return self._rays_from_pixels(cam_idx, px, py, aabb)

    def _rays_from_pixels(self, cam_idx, px, py, aabb) -> RayBundle:
        dirs, pixel_area = self._pixel_to_directions(cam_idx, px, py)
        origins = self.camera_to_worlds[cam_idx][..., :3, 3].expand(dirs.shape)
        near_arr = far_arr = None
        if aabb is not None:
            n, f = intersect_with_aabb(origins, dirs, aabb)
            near_arr = n.clamp_min(0.0)
            far_arr = torch.maximum(f, near_arr + 1e-6)
        return RayBundle(
            origins=origins,
            directions=dirs,
            pixel_area=pixel_area,
            camera_indices=cam_idx[..., None].to(torch.int32),
            nears=near_arr,
            fars=far_arr,
        )
