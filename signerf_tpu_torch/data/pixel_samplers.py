"""Pixel and patch sampling for ray batches.

Port of `signerf_tpu/data/pixel_samplers.py`. Each sampler draws from an
explicit `torch.Generator` that lives on the images' device, so the draws
happen where the images are; a generator on another device raises.
"""

from __future__ import annotations

import torch


def _randint(generator: torch.Generator, high: int, n: int) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=generator, device=generator.device)


def sample_pixels(
    generator: torch.Generator, num_rays: int, num_images: int, height: int, width: int
) -> torch.Tensor:
    """Uniform random pixel indices [num_rays, 3] int32 = (camera, y, x)."""
    cam = _randint(generator, num_images, num_rays)
    ys = _randint(generator, height, num_rays)
    xs = _randint(generator, width, num_rays)
    return torch.stack([cam, ys, xs], dim=-1).to(torch.int32)


def sample_pixels_masked(
    generator: torch.Generator, num_rays: int, mask_indices: torch.Tensor
) -> torch.Tensor:
    """Rays drawn uniformly from a precomputed [M, 3] valid-pixel list."""
    idx = _randint(generator, mask_indices.shape[0], num_rays)
    return mask_indices[idx]


def sample_patches(
    generator: torch.Generator,
    num_rays: int,
    patch_size: int,
    num_images: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Random patch indices [N, 3] with N = floor(num_rays / ps^2) * ps^2;
    every patch lies inside the image, patch-major then row-major."""
    ps = patch_size
    num_patches = num_rays // (ps * ps)
    cam = _randint(generator, num_images, num_patches)
    y0 = _randint(generator, max(height - ps, 1), num_patches)
    x0 = _randint(generator, max(width - ps, 1), num_patches)
    dev = generator.device
    dy, dx = torch.meshgrid(
        torch.arange(ps, device=dev), torch.arange(ps, device=dev), indexing="ij"
    )
    ys = y0[:, None, None] + dy[None]
    xs = x0[:, None, None] + dx[None]
    cams = cam[:, None, None].expand(ys.shape)
    return torch.stack([cams, ys, xs], dim=-1).reshape(-1, 3).to(torch.int32)


def gather_pixels(images: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """images [N, H, W, C], indices [R, 3] -> [R, C]."""
    idx = indices.long()
    return images[idx[:, 0], idx[:, 1], idx[:, 2]]
