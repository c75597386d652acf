"""Full-image quality metrics: PSNR and SSIM.

Port of `signerf_tpu/ops/image_metrics.py` (Wang et al. SSIM with an 11x11
Gaussian window, sigma 1.5, valid padding). The separable blur is written
as two matrix products with banded [H-10, H] and [W, W-10] matrices instead
of a convolution: a float32 convolution would go through cuDNN in TF32 on
the card by default, and a float32 matmul runs in full float32.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1], any matching shape -> scalar dB."""
    mse = ((pred - target) ** 2).mean()
    return -10.0 * torch.log10(mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band(n: int, k: torch.Tensor) -> torch.Tensor:
    """[n - K + 1, n] matrix whose rows are the kernel shifted by one."""
    size = k.shape[0]
    m = torch.zeros(n - size + 1, n, dtype=k.dtype, device=k.device)
    for i in range(n - size + 1):
        m[i, i : i + size] = k
    return m


def _blur(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Separable valid blur of [H, W, C]: rows [H', H] @ x @ cols^T per channel."""
    img = x.permute(2, 0, 1)  # [C, H, W]
    return (rows @ img @ cols.T).permute(1, 2, 0)


def ssim(
    pred: torch.Tensor,  # [H, W, C] in [0, 1]
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    k = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(pred.device)
    rows, cols = _band(pred.shape[0], k), _band(pred.shape[1], k)
    blur = lambda x: _blur(x, rows, cols)  # noqa: E731
    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y = blur(pred), blur(target)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = blur(pred * pred) - mu_xx
    sigma_yy = blur(target * target) - mu_yy
    sigma_xy = blur(pred * target) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return (num / den).mean()
