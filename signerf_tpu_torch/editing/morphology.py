"""Binary mask dilation with an elliptical structuring element.

Port of `signerf_tpu/editing/morphology.py`: the reference dilates with
`cv2.dilate(mask, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, size))`,
default size (50, 50). Dilation of a binary mask equals "convolve with the
structuring element, then > 0".

The structuring element follows cv2's own rule, in numpy, without cv2:
r = h // 2, c = w // 2, and row i keeps the columns
[max(c - dx, 0), min(c + dx + 1, w)) with dx = cvRound(c sqrt((r^2 - dy^2)
/ r^2)), dy = i - r (dx = 0 when r = 0). It equals cv2's element bit for
bit at every size; the JAX package's own fallback (taken where cv2 is not
importable) differs from cv2 at even sizes (119 of 2,500 pixels at
(50, 50)).

On the card the convolution runs in f32 with cuDNN's TF32 off: sums of up
to w h zeros and ones are exact in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (width, height)) -> [height, width] float32."""
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((height, width), np.float32)
    for i in range(height):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))  # cvRound: half to even
        out[i, max(c - dx, 0) : min(c + dx + 1, width)] = 1.0
    return out


def dilate(mask: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Dilate a [H, W] or [H, W, 1] binary mask by an elliptical element of
    ``size`` = (width, height), as cv2's (ksize.width, ksize.height).
    Returns a float mask in {0, 1} with the input's rank, on its device."""
    squeeze = mask.dim() == 3
    m = (mask[..., 0] if squeeze else mask).float()
    kern = torch.from_numpy(ellipse_kernel(int(size[0]), int(size[1]))).to(m.device)
    kh, kw = kern.shape
    # JAX's padding ((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)): the
    # anchor at (kw // 2, kh // 2), as cv2's
    x = F.pad(m[None, None], (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x, kern[None, None])[0, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = (out > 0).float()
    return out[..., None] if squeeze else out
