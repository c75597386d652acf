"""Data manager: image loading and the device-resident training images.

Port of `signerf_tpu/data/datamanager.py`. As in the JAX package, the
images sit on the device as one uint8 [N, H, W, 3] tensor and pixel sampling
and ray generation run in the train step, so there is no loader process and
no host-to-device copy after start-up. Images are read with the port's own
PNG decoder (`utils/images.py`); other formats need Pillow.

An image whose size differs from its camera's is resized to the camera's
size, as the JAX loader does: images bilinearly with the arithmetic of the
JAX package's native PNG codec (`native/image_codec.cpp`, the path it takes
for PNGs), masks by nearest neighbour with Pillow's `NEAREST` sampling.

Not ported yet: the `CachedImageStore` subset cache (its `cache_images`
knobs are unknown keys; every image is held on the device).
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


def resize_bilinear_u8(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [h, w, C] -> uint8 [height, width, C]: half-pixel bilinear
    without antialiasing, in float32, rounded half up; the same operations
    in the same order as the native codec's `resize_bilinear`."""
    src_h, src_w = a.shape[:2]
    if (src_h, src_w) == (height, width):
        return a
    f32 = np.float32

    def taps(n_out, n_in):
        scale = f32(n_in) / f32(n_out)
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        i0 = np.where(pos < 0, 0, pos.astype(np.int64))
        i1 = np.minimum(i0 + 1, n_in - 1)
        frac = np.maximum(pos - i0.astype(f32), f32(0.0))
        return i0, i1, frac

    y0, y1, wy = taps(height, src_h)
    x0, x1, wx = taps(width, src_w)
    src = a.astype(f32)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = f32(1.0)
    v = (
        src[y0][:, x0] * (one - wy) * (one - wx)
        + src[y0][:, x1] * (one - wy) * wx
        + src[y1][:, x0] * wy * (one - wx)
        + src[y1][:, x1] * wy * wx
    )
    return (v + f32(0.5)).astype(np.uint8)


def resize_nearest(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """[h, w, ...] -> [height, width, ...] by Pillow's `NEAREST` rule: the
    source index of output pixel i is floor(s / 2 + i s), s = in / out, the
    sum accumulated in float64 one pixel at a time."""
    src_h, src_w = a.shape[:2]
    if (src_h, src_w) == (height, width):
        return a

    def index(n_out, n_in):
        step = n_in / n_out
        pos = np.cumsum(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
        return np.minimum(pos.astype(np.int64), n_in - 1)

    return a[index(height, src_h)][:, index(width, src_w)]


def load_images(
    filenames: Sequence[Path], width: int, height: int, max_workers: int = 8
) -> np.ndarray:
    """Decode images to a [N, H, W, 3] uint8 stack at the cameras' size."""
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        arrays = list(ex.map(lambda p: resize_bilinear_u8(load_rgb(p), width, height), filenames))
    return np.stack(arrays, axis=0)


def load_masks(
    filenames: Sequence[Optional[Path]], width: int, height: int, max_workers: int = 8
) -> np.ndarray:
    """[N, H, W] float {0, 1} masks (gray > 127); a missing file is all
    white, as for the generated frames of an edited dataset."""

    def one(p: Optional[Path]) -> np.ndarray:
        if p is None or not Path(p).exists():
            return np.ones((height, width), np.float32)
        return (resize_nearest(load_gray(p), width, height) > 127).astype(np.float32)

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
