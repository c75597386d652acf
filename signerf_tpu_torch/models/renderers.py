"""Volumetric compositing: rgb, accumulation, median and expected depth,
normals.

Port of `signerf_tpu/models/renderers.py` (nerfacto's RGBRenderer,
AccumulationRenderer, DepthRenderer and NormalsRenderer semantics).
"""

from __future__ import annotations

import torch


def render_rgb(
    weights: torch.Tensor,  # [R, S]
    rgbs: torch.Tensor,  # [R, S, 3]
    background_color: str = "last_sample",
) -> torch.Tensor:
    acc = weights.sum(-1, keepdim=True)
    comp = (weights[..., None] * rgbs).sum(-2)
    if background_color == "last_sample":
        bg = rgbs[..., -1, :]
    elif background_color == "white":
        bg = torch.ones_like(comp)
    elif background_color == "black":
        bg = torch.zeros_like(comp)
    else:
        raise ValueError(f"unknown background_color {background_color!r}")
    return (comp + bg * (1.0 - acc)).clamp(0.0, 1.0)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """[R, S] -> [R, 1] total opacity."""
    return weights.sum(-1, keepdim=True)


def render_depth_expected(
    weights: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Expected termination depth [R, 1], normalized by accumulation."""
    mids = 0.5 * (starts + ends)
    acc = weights.sum(-1, keepdim=True)
    depth = (weights * mids).sum(-1, keepdim=True) / acc.clamp_min(1e-10)
    return torch.minimum(torch.maximum(depth, mids[..., :1]), mids[..., -1:])


def render_depth_median(
    weights: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Median termination depth [R, 1]: the first sample whose cumulative
    weight reaches 0.5, or the last sample when none does."""
    mids = 0.5 * (starts + ends)
    crossed = weights.cumsum(-1) >= 0.5
    idx = crossed.int().argmax(-1)  # first True; 0 when none
    idx = torch.where(crossed.any(-1), idx, torch.full_like(idx, mids.shape[-1] - 1))
    return mids.gather(-1, idx[..., None])


def render_normals(weights: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Composite per-sample normals [R, S, 3] -> [R, 3], not renormalized
    (nerfstudio's NormalsRenderer)."""
    return (weights[..., None] * normals).sum(-2)
