"""Cameras on an arc for novel-view evaluation, and the eval camera loaders.

Port of `signerf_tpu/data/camera_arc.py`: `CameraArcDataset` puts
`num_cameras` pinhole cameras on a circle around a target (no images: they
are render targets), `EvalCameraDataloader` walks any `Cameras` round-robin
and `FixedIndicesEvalCameraDataloader` walks a list of indices once. Both
yield `(camera index, full-image RayBundle)` from `Cameras.generate_rays`,
on the cameras' device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from signerf_tpu_torch.cameras.cameras import Cameras, RayBundle
from signerf_tpu_torch.cameras.poses import circle_poses


@dataclasses.dataclass
class CameraArcDatasetConfig:
    num_cameras: int = 10
    radius: float = 1.0
    theta: float = 70.0  # polar angle, degrees
    phi_range: Tuple[float, float] = (0.0, 360.0)
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    width: int = 512
    height: int = 512
    fx: float = 512.0
    fy: float = 512.0


class CameraArcDataset:
    """`config.num_cameras` look-at cameras on a circle (`circle_poses`),
    principal point at the image center, on `device` (the card unless the
    caller names another)."""

    def __init__(self, config: CameraArcDatasetConfig, device=None):
        self.config = config
        device = torch.device("cuda" if device is None else device)
        n = config.num_cameras
        poses = circle_poses(
            n,
            radius=config.radius,
            theta=config.theta,
            phi=config.phi_range,
            position=config.position,
            target=config.target,
        )  # [N, 4, 4]
        full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=device)  # noqa: E731
        self.cameras = Cameras(
            camera_to_worlds=poses[:, :3, :].to(device),
            fx=full(config.fx),
            fy=full(config.fy),
            cx=full(config.width / 2.0),
            cy=full(config.height / 2.0),
            width=config.width,
            height=config.height,
        )

    def __len__(self) -> int:
        return self.config.num_cameras


class EvalCameraDataloader:
    """Cameras round-robin, forever: (camera index, [H, W] RayBundle), the
    rays clipped to `aabb` [2, 3] when given."""

    def __init__(self, cameras: Cameras, aabb: Optional[torch.Tensor] = None):
        self.cameras = cameras
        self.aabb = None if aabb is None else torch.as_tensor(aabb, dtype=torch.float32, device=cameras.device)
        self._idx = 0

    def __iter__(self) -> Iterator[Tuple[int, RayBundle]]:
        return self

    def __next__(self) -> Tuple[int, RayBundle]:
        i = self._idx % len(self.cameras)
        self._idx += 1
        return i, self.cameras.generate_rays(camera_index=i, aabb=self.aabb)


class FixedIndicesEvalCameraDataloader(EvalCameraDataloader):
    """One pass over `indices`, in their order."""

    def __init__(self, cameras: Cameras, indices: Sequence[int], aabb: Optional[torch.Tensor] = None):
        super().__init__(cameras, aabb)
        self.indices: List[int] = list(indices)

    def __iter__(self) -> Iterator[Tuple[int, RayBundle]]:
        for i in self.indices:
            yield i, self.cameras.generate_rays(camera_index=i, aabb=self.aabb)

    def __next__(self):
        raise TypeError("iterate over the loader: it walks its indices once")
