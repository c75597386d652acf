"""Ray sample container: [R, S] samples along R rays.

Port of `signerf_tpu/models/ray_samples.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RaySamples:
    """``starts``/``ends`` are euclidean bin edges along the ray;
    ``spacing_starts``/``spacing_ends`` the same bins in normalized s-space,
    where the proposal sampler works."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3]
    starts: torch.Tensor  # [R, S]
    ends: torch.Tensor  # [R, S]
    spacing_starts: torch.Tensor  # [R, S]
    spacing_ends: torch.Tensor  # [R, S]
    camera_indices: Optional[torch.Tensor] = None  # [R]
    pixel_area: Optional[torch.Tensor] = None  # [R]

    @property
    def num_samples(self) -> int:
        return self.starts.shape[-1]

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def midpoints(self) -> torch.Tensor:
        return 0.5 * (self.starts + self.ends)

    @property
    def positions(self) -> torch.Tensor:
        """Frustum center positions [R, S, 3]."""
        return self.origins[:, None, :] + self.directions[:, None, :] * self.midpoints[..., None]

    @property
    def spacing_bins(self) -> torch.Tensor:
        """[R, S+1] s-space bin edges (starts + last end)."""
        return torch.cat([self.spacing_starts, self.spacing_ends[..., -1:]], dim=-1)
