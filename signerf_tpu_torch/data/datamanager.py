"""Data manager: image loading and the device-resident training images.

Port of `signerf_tpu/data/datamanager.py`. As in the JAX package, the
images sit on the device as one uint8 [N, H, W, 3] tensor and pixel sampling
and ray generation run in the train step, so there is no loader process and
no host-to-device copy after start-up. Images are read with the port's own
PNG decoder (`utils/images.py`); other formats need Pillow.

Not ported yet: resizing an image whose size differs from its camera's (it
raises instead) and the `CachedImageStore` subset cache (its
`cache_images` knobs are unknown keys; every image is held on the device).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from signerf_tpu_torch.data.dataparser import (
    DataparserOutputs,
    SIGNeRFDataParserConfig,
    parse_transforms,
)
from signerf_tpu_torch.utils.images import load_gray, load_rgb


def _check_size(path: Path, a: np.ndarray, width: int, height: int) -> np.ndarray:
    if a.shape[:2] != (height, width):
        raise ValueError(
            f"{path}: image is {a.shape[1]}x{a.shape[0]}, its camera {width}x{height}; "
            "the port does not resize images"
        )
    return a


def load_images(
    filenames: Sequence[Path], width: int, height: int, max_workers: int = 8
) -> np.ndarray:
    """Decode images to a [N, H, W, 3] uint8 stack."""
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        arrays = list(ex.map(lambda p: _check_size(p, load_rgb(p), width, height), filenames))
    return np.stack(arrays, axis=0)


def load_masks(
    filenames: Sequence[Optional[Path]], width: int, height: int, max_workers: int = 8
) -> np.ndarray:
    """[N, H, W] float {0, 1} masks (gray > 127); a missing file is all
    white, as for the generated frames of an edited dataset."""

    def one(p: Optional[Path]) -> np.ndarray:
        if p is None or not Path(p).exists():
            return np.ones((height, width), np.float32)
        return (_check_size(p, load_gray(p), width, height) > 127).astype(np.float32)

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        arrays = list(ex.map(one, filenames))
    return np.stack(arrays, axis=0)


def mask_indices_from_masks(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] {0, 1} -> [M, 3] int32 (cam, y, x) of the valid pixels."""
    return np.argwhere(masks > 0.5).astype(np.int32)


@dataclasses.dataclass
class SIGNeRFDataManagerConfig:
    dataparser: SIGNeRFDataParserConfig = dataclasses.field(
        default_factory=SIGNeRFDataParserConfig
    )
    train_num_rays_per_batch: int = 4096
    patch_size: int = 1
    micro_batches: int = 0  # 0: auto (see auto_micro_batches)


def auto_micro_batches(num_rays: int, patch_size: int, use_mask: bool) -> int:
    """Smallest gradient-accumulation split that divides num_rays, keeps
    micro-batches near 4096 rays, and holds whole patches when patch
    sampling is on; monolithic when no split up to 64 exists."""
    grain = patch_size * patch_size if (patch_size > 1 and not use_mask) else 1
    target = max(1, -(-num_rays // 4096))
    for m in range(target, 65):
        if num_rays % m == 0 and (num_rays // m) % grain == 0:
            return m
    return 1


class SIGNeRFDataManager:
    """The parsed dataset, its cameras and its images on `device`."""

    def __init__(self, config: SIGNeRFDataManagerConfig, device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.outputs: DataparserOutputs = parse_transforms(config.dataparser)
        self.cameras = self.outputs.cameras.to(self.device)
        cams = self.cameras
        images = load_images(self.outputs.image_filenames, cams.width, cams.height)
        self.images = torch.from_numpy(images).to(self.device)
        self.mask_indices: Optional[torch.Tensor] = None
        if self.outputs.mask_filenames is not None:
            masks = load_masks(self.outputs.mask_filenames, cams.width, cams.height)
            self.mask_indices = torch.from_numpy(mask_indices_from_masks(masks)).to(self.device)

    @property
    def num_images(self) -> int:
        return self.images.shape[0]

    def sampler_settings(self):
        from signerf_tpu_torch.engine.train_step import SamplerSettings

        # A mask forces plain pixel sampling even with patch_size > 1.
        num_rays = self.config.train_num_rays_per_batch
        use_mask = self.mask_indices is not None
        patch = self.config.patch_size
        micro = self.config.micro_batches
        if micro <= 0:
            micro = auto_micro_batches(num_rays, patch, use_mask)
        return SamplerSettings(
            num_rays=num_rays, patch_size=patch, use_mask=use_mask, micro_batches=micro
        )
