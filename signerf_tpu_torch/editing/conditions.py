"""Mask + depth-condition synthesis for the two selection modes.

Port of `signerf_tpu/editing/conditions.py` (the reference's
`DatasetGenerator.render_camera` masking block):

  * mode "shape": the proxy-mesh occlusion test ``mesh_depth < nerf_depth``
    on pixels the mesh covers;
  * mode "aabb": the ray/box interval test ``nears < nerf_depth < fars``
    with ``nears > 0`` (cameras inside the box ignored);
  * elliptical mask dilation, default (50, 50);
  * normalized inverted depth conditions: a depth window from the selected
    depth +- additional_depth_radius (or manual_depth), normalized,
    clamped, inverted;
  * ``combine_shape_with_depth``: the mesh's colour channel composited into
    the AABB condition where the mesh is visible;
  * ``inverse_mask`` flips the selection;
  * an empty selection yields a zero mask and a zero condition.

The JAX module's quirks are kept on purpose: in shape mode the window's
top is the max over ALL mesh depth, not just the selection; an empty
selection makes the window inf / NaN, and `_finalize` then zeroes mask and
condition through `torch.where` (no data-dependent branch, so nothing
waits for the device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from signerf_tpu_torch.editing.morphology import dilate
from signerf_tpu_torch.ops.intersection import intersect_with_aabb

_INF = float("inf")


@dataclasses.dataclass
class MaskingConfig:
    """The masking knobs of the dataset generator's config."""

    masking_mode: str = "aabb"  # "aabb" | "shape"
    aabb_min: Tuple[float, float, float] = (-0.1, -0.1, -0.1)
    aabb_max: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    mask_dilation: Optional[Tuple[int, int]] = (50, 50)
    additional_depth_radius: float = 0.1
    manual_depth: Optional[Tuple[float, float]] = None
    inverse_mask: bool = False
    combine_shape_with_depth: bool = False


def _finalize(
    visible: torch.Tensor,  # [H, W, 1] float {0, 1} raw (pre-dilation) mask
    mask: torch.Tensor,  # [H, W, 1] float {0, 1} (post-dilation) mask
    condition: torch.Tensor,  # [H, W, 1]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero mask and condition when nothing is visible (the reference's
    behaviour for empty selections)."""
    is_visible = visible.sum() > 1e-6
    return (torch.where(is_visible, mask, torch.zeros_like(mask)),
            torch.where(is_visible, condition, torch.zeros_like(condition)))


def _depth_window(d_min: torch.Tensor, d_max: torch.Tensor, cfg: MaskingConfig):
    if cfg.manual_depth is not None:
        return (torch.tensor(float(cfg.manual_depth[0]), device=d_min.device),
                torch.tensor(float(cfg.manual_depth[1]), device=d_min.device))
    return d_min - cfg.additional_depth_radius, d_max + cfg.additional_depth_radius


def _dilated(visible: torch.Tensor, cfg: MaskingConfig) -> torch.Tensor:
    return dilate(visible, cfg.mask_dilation) if cfg.mask_dilation else visible


def shape_mask_condition(
    nerf_depth: torch.Tensor,  # [H, W, 1]
    mesh_depth: torch.Tensor,  # [H, W, 1], 0 where no mesh
    cfg: MaskingConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask [H, W, 1] {0, 1}, condition [H, W, 1]) of the proxy mesh."""
    non_empty = mesh_depth > 0
    visible = ((mesh_depth < nerf_depth) & non_empty).float()
    if cfg.inverse_mask:
        visible = 1.0 - visible
    mask = _dilated(visible, cfg)

    sel = (visible > 0) & (mesh_depth > 0)
    d_min = torch.where(sel, mesh_depth, torch.full_like(mesh_depth, _INF)).amin()
    d_max = mesh_depth.amax()
    lo, hi = _depth_window(d_min, d_max, cfg)
    rng = (hi - lo).clamp_min(1e-8)
    obj_n = (mesh_depth - lo) / rng
    nerf_n = (nerf_depth - lo) / rng
    condition = visible * obj_n + (1.0 - visible) * nerf_n
    condition = 1.0 - condition.clamp(0.0, 1.0)
    return _finalize(visible, mask, condition)


def aabb_mask_condition(
    nerf_depth: torch.Tensor,  # [H, W, 1]
    rays_o: torch.Tensor,  # [H, W, 3]
    rays_d: torch.Tensor,  # [H, W, 3]
    cfg: MaskingConfig,
    mesh_depth: Optional[torch.Tensor] = None,  # for combine_shape_with_depth
    mesh_color: Optional[torch.Tensor] = None,  # [H, W, 3] (0..1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask [H, W, 1] {0, 1}, condition [H, W, 1]) of the box selection."""
    aabb = torch.tensor([cfg.aabb_min, cfg.aabb_max], dtype=torch.float32, device=nerf_depth.device)
    nears, fars = intersect_with_aabb(rays_o, rays_d, aabb)  # [H, W, 1]
    non_empty = (nears < fars) & (nears > 0.0)
    visible = ((nears < nerf_depth) & (nerf_depth < fars) & non_empty).float()
    if cfg.inverse_mask:
        visible = 1.0 - visible
    mask = _dilated(visible, cfg)

    sel = (nerf_depth * visible) > 0
    d_min = torch.where(sel, nerf_depth, torch.full_like(nerf_depth, _INF)).amin()
    d_max = torch.where(sel, nerf_depth, torch.full_like(nerf_depth, -_INF)).amax()
    lo, hi = _depth_window(d_min, d_max, cfg)
    rng = (hi - lo).clamp_min(1e-8)

    if cfg.combine_shape_with_depth and mesh_depth is not None:
        cam_visible = ((mesh_depth < nerf_depth) & (mesh_depth > 0)).float()
        nerf_n = (nerf_depth - lo) / rng
        color_ch = mesh_color[..., :1] if mesh_color is not None else torch.zeros_like(nerf_depth)
        condition = cam_visible * color_ch + (1.0 - cam_visible) * nerf_n
    else:
        condition = (nerf_depth - lo) / rng
    condition = 1.0 - condition.clamp(0.0, 1.0)
    return _finalize(visible, mask, condition)
