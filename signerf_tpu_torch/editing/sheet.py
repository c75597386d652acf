"""Reference-sheet composition, splicing and splitting.

Port of `signerf_tpu/editing/sheet.py` (the reference's
`generate_reference_sheet` and `generate_with_reference_sheet`): an r x c
grid of downscaled views with a border between cells, padded up to a
multiple of 8 (image sheet initialized to ones, mask and condition to
zeros); the blend ``edited * mask + original * (1 - mask)``; the split back
into cells; the per-view splice into the LAST cell.

Images are [H, W, C] float tensors, as in the JAX module. Resizes are
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)`,
the half-pixel sampling of `jax.image.resize(..., "linear",
antialias=False)`. `resize_mask` thresholds a resized mask at > 0.5; a
downscale by 2 puts many pixels at exactly 0.5, where the card's fused
multiply-adds may round to the other side of the threshold than the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SheetLayout:
    rows: int = 2
    cols: int = 3
    cell_height: int = 0  # scaled image dims
    cell_width: int = 0
    border: int = 0  # border_width_between_images

    @property
    def height(self) -> int:
        """Sheet height padded up to a multiple of 8."""
        h = self.rows * self.cell_height + (self.rows - 1) * self.border
        return int(math.ceil(h / 8) * 8)

    @property
    def width(self) -> int:
        w = self.cols * self.cell_width + (self.cols - 1) * self.border
        return int(math.ceil(w / 8) * 8)

    def cell_slice(self, index: int) -> Tuple[slice, slice]:
        """(row_slice, col_slice) of grid cell ``index`` (row-major)."""
        row, col = index // self.cols, index % self.cols
        r0 = row * (self.cell_height + self.border)
        c0 = col * (self.cell_width + self.border)
        return slice(r0, r0 + self.cell_height), slice(c0, c0 + self.cell_width)

    @property
    def last_index(self) -> int:
        return self.rows * self.cols - 1


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, C] -> [height, width, C] bilinear (align_corners=False)."""
    x = img.float().permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0)


def resize_mask(mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize, then threshold > 0.5."""
    return (resize_bilinear(mask, height, width) > 0.5).float()


def compose_sheet(
    layout: SheetLayout,
    images: List[torch.Tensor],  # each [ch, cw, 3], already scaled
    masks: List[torch.Tensor],  # each [ch, cw, 1]
    conditions: List[torch.Tensor],  # each [ch, cw, 1]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place up to r * c views into the grid, row-major (the reference
    sheet leaves the last cell empty). Returns (image_sheet [H, W, 3]
    initialized to ones, mask_sheet [H, W, 1] and condition_sheet
    [H, W, 1] initialized to zeros), on the first image's device."""
    h, w = layout.height, layout.width
    dev = images[0].device
    image_sheet = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
    mask_sheet = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    cond_sheet = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    for i, (img, msk, cnd) in enumerate(zip(images, masks, conditions)):
        rs, cs = layout.cell_slice(i)
        image_sheet[rs, cs] = img
        mask_sheet[rs, cs] = msk
        cond_sheet[rs, cs] = cnd
    return image_sheet, mask_sheet, cond_sheet


def splice_last_cell(
    layout: SheetLayout,
    image_sheet: torch.Tensor,
    condition_sheet: torch.Tensor,
    render_scaled: torch.Tensor,  # [ch, cw, 3]
    mask_scaled: torch.Tensor,  # [ch, cw, 1]
    condition_scaled: torch.Tensor,  # [ch, cw, 1]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-view generation: the target view in the LAST grid cell; the mask
    sheet is zero everywhere but that cell. The input sheets are not
    changed (new tensors are returned)."""
    rs, cs = layout.cell_slice(layout.last_index)
    image_sheet = image_sheet.clone()
    image_sheet[rs, cs] = render_scaled
    mask_sheet = torch.zeros_like(condition_sheet)
    mask_sheet[rs, cs] = mask_scaled
    condition_sheet = condition_sheet.clone()
    condition_sheet[rs, cs] = condition_scaled
    return image_sheet, mask_sheet, condition_sheet


def blend_with_mask(edited: torch.Tensor, original: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """edited * mask + original * (1 - mask)."""
    return edited * mask + original * (1.0 - mask)


def split_cells(layout: SheetLayout, sheet: torch.Tensor, count: int) -> List[torch.Tensor]:
    """The first ``count`` cells of a sheet."""
    return [sheet[layout.cell_slice(i)] for i in range(count)]


def extract_last_cell(layout: SheetLayout, sheet: torch.Tensor) -> torch.Tensor:
    rs, cs = layout.cell_slice(layout.last_index)
    return sheet[rs, cs]
