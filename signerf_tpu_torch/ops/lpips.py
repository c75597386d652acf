"""LPIPS perceptual distance (AlexNet or VGG16 backbone + linear heads).

Port of `signerf_tpu/ops/lpips.py`:

    d(x, y) = sum_l  mean_hw  sum_c max(w_l, 0)_c (phi_l(x)/|phi_l(x)| - phi_l(y)/|phi_l(y)|)_c^2

with phi_l the backbone's ReLU stages after the ImageNet shift and scale,
|.| the channel norm (floored at 1e-10). Images keep the JAX package's
NHWC layout at the public functions; the convolutions run NCHW through
`torch.nn.functional.conv2d` (the JAX package leaves them to XLA outside any
Pallas kernel, so there is no kernel to port here).

Parameters: `LPIPSParams` with OIHW conv kernels. `load_weights` reads the
JAX package's `.npz` export (HWIO `conv{i}_kernel`, `conv{i}_bias`,
`lin{i}`); without one, `init_lpips` draws a He-initialised backbone from a
`torch.Generator`, which is a random-feature distance and not calibrated
LPIPS (the callers warn).

Precision: on the card cuDNN runs f32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32`), which keeps about 10 mantissa bits, so
LPIPS would move by about 1e-3 relative. The port's train and eval CLIs
turn TF32 off (`full_f32_convolutions`), so the distance and its gradient
are computed in f32 and agree with the CPU to f32 rounding.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, kernel, stride, padding) per AlexNet conv; features are
# taken after each ReLU, with a 3x3/2 max pool after the first two.
_ALEX_LAYERS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_POOL_AFTER = {0, 1}
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_VGG_CAPTURE = {1, 3, 6, 9, 12}  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@dataclasses.dataclass
class LPIPSParams:
    convs: List[Dict[str, torch.Tensor]]  # {"kernel": [out, in, k, k], "bias": [out]}
    lins: List[torch.Tensor]  # [C_l] per-channel weights (clamped at 0 in use)
    net: str = "alex"

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "LPIPSParams":
        return LPIPSParams(
            convs=[{k: fn(v) for k, v in c.items()} for c in self.convs],
            lins=[fn(w) for w in self.lins],
            net=self.net,
        )


def full_f32_convolutions() -> None:
    """Turn cuDNN's TF32 off for f32 convolutions (forward and backward)."""
    torch.backends.cudnn.allow_tf32 = False


def init_lpips(generator: torch.Generator, net: str = "alex") -> LPIPSParams:
    """He-initialised backbone and unit linear heads (1 / C per channel)."""
    if net == "alex":
        shapes = [(out, k) for out, k, _, _ in _ALEX_LAYERS]
        caps = [out for out, _ in shapes]
    elif net == "vgg":
        shapes = [(v, 3) for v in _VGG_CFG if v != "M"]
        caps = [shapes[i][0] for i in sorted(_VGG_CAPTURE)]
    else:
        raise ValueError(f"unknown net {net!r}")
    convs, in_ch = [], 3
    for out, k in shapes:
        w = torch.randn(out, in_ch, k, k, generator=generator) * (2.0 / (k * k * in_ch)) ** 0.5
        convs.append({"kernel": w, "bias": torch.zeros(out)})
        in_ch = out
    return LPIPSParams(convs=convs, lins=[torch.ones(c) / c for c in caps], net=net)


def from_hwio(convs, lins, net: str) -> LPIPSParams:
    """Arrays in the JAX package's layout (conv kernels HWIO [k, k, in, out])
    -> f32 `LPIPSParams` (OIHW)."""
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    return LPIPSParams(
        convs=[{"kernel": as_t(c["kernel"]).permute(3, 2, 0, 1).contiguous(), "bias": as_t(c["bias"])}
               for c in convs],
        lins=[as_t(w) for w in lins],
        net=net,
    )


def load_weights(path: str | Path, net: str = "alex") -> LPIPSParams:
    """An exported `.npz` (`conv{i}_kernel` HWIO, `conv{i}_bias`, `lin{i}`),
    the format `scripts/export_lpips_weights.py` writes and the JAX
    package's `load_weights` reads."""
    data = np.load(Path(path))
    convs, lins = [], []
    while f"conv{len(convs)}_kernel" in data:
        i = len(convs)
        convs.append({"kernel": data[f"conv{i}_kernel"], "bias": data[f"conv{i}_bias"]})
    while f"lin{len(lins)}" in data:
        lins.append(data[f"lin{len(lins)}"])
    return from_hwio(convs, lins, net)


def _features(params: LPIPSParams, x: torch.Tensor) -> List[torch.Tensor]:
    """x [N, H, W, 3] in [-1, 1] -> the captured stages, NCHW."""
    shift = x.new_tensor(_SHIFT)
    scale = x.new_tensor(_SCALE)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    if params.net == "alex":
        for i, ((_, _, stride, pad), conv) in enumerate(zip(_ALEX_LAYERS, params.convs)):
            x = torch.relu(F.conv2d(x, conv["kernel"], conv["bias"], stride=stride, padding=pad))
            feats.append(x)
            if i in _ALEX_POOL_AFTER and x.shape[2] >= 3:
                x = F.max_pool2d(x, 3, 2)
        return feats
    ci = 0
    for v in _VGG_CFG:
        if v == "M":
            if x.shape[2] >= 2:
                x = F.max_pool2d(x, 2, 2)
            continue
        conv = params.convs[ci]
        x = torch.relu(F.conv2d(x, conv["kernel"], conv["bias"], stride=1, padding=1))
        if ci in _VGG_CAPTURE:
            feats.append(x)
        ci += 1
    return feats


def lpips(params: LPIPSParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per image pair: x, y [N, H, W, 3] in [-1, 1] -> [N]."""
    total = x.new_zeros(x.shape[0])
    for f1, f2, w in zip(_features(params, x), _features(params, y), params.lins):
        n1 = f1 / f1.norm(dim=1, keepdim=True).clamp_min(1e-10)
        n2 = f2 / f2.norm(dim=1, keepdim=True).clamp_min(1e-10)
        diff = (n1 - n2) ** 2  # [N, C, h, w]
        total = total + (diff * w.clamp_min(0.0)[:, None, None]).sum(1).mean((1, 2))
    return total
