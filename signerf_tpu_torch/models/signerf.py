"""SIGNeRF model: nerfacto with an L1 (or MSE) rgb loss and the LPIPS patch
loss.

Port of `signerf_tpu/models/signerf.py` (reference signerf.py:14-82): the
rgb loss is L1 or MSE; LPIPS runs over `patch_size` x `patch_size` patches
mapped to [-1, 1] and clamped; the inherited interlevel, distortion,
orientation and pred-normal losses are kept while training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from signerf_tpu_torch.models import losses as L
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from signerf_tpu_torch.ops.lpips import LPIPSParams, init_lpips, load_weights, lpips
from signerf_tpu_torch.utils.calibration import warn_uncalibrated

# Seed of the random LPIPS backbone when no weights are given (the JAX
# package's PRNGKey(0)).
LPIPS_SEED = 0


@dataclasses.dataclass
class SIGNeRFModelConfig(NerfactoModelConfig):
    """The JAX package's SIGNeRF knobs and defaults (the `signerf`
    method's; `signerf_nerfacto` turns LPIPS and L1 off)."""

    use_lpips: bool = True
    use_l1: bool = True
    patch_size: int = 32
    lpips_loss_mult: float = 1.0
    lpips_net: str = "alex"
    lpips_weights_path: Optional[str] = None  # .npz export; random init if None


class SIGNeRFModel(NerfactoModel):
    """Nerfacto with SIGNeRF's refinement losses.

    The LPIPS parameters are frozen and held as a plain attribute, outside
    `named_parameters()` and `state_dict()`: the optimizer sends every
    parameter name it does not know to the `fields` group, so an LPIPS
    child module would be trained and checkpointed (the reference filters
    its LPIPS module out of checkpoints). `.to()` moves them with the
    model."""

    config: SIGNeRFModelConfig

    def __init__(self, config: SIGNeRFModelConfig, num_train_images: int):
        super().__init__(config, num_train_images)
        self.lpips_params: Optional[LPIPSParams] = None
        if config.use_lpips:
            if config.lpips_weights_path:
                self.lpips_params = load_weights(config.lpips_weights_path, config.lpips_net)
            else:
                warn_uncalibrated(
                    "LPIPS",
                    "the logged 'lpips_loss' is a random-feature perceptual distance, NOT "
                    "calibrated LPIPS. Export real weights to .npz "
                    "(scripts/export_lpips_weights.py) and set lpips_weights_path.",
                )
                self.lpips_params = init_lpips(torch.Generator().manual_seed(LPIPS_SEED), config.lpips_net)

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        if self.lpips_params is not None:
            self.lpips_params = self.lpips_params.map(fn)
        return self

    def loss_dict(
        self, outputs: Dict[str, Any], batch: Dict[str, torch.Tensor], train: bool = True
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        loss = super().loss_dict(outputs, batch, train)
        pred, target = outputs["rgb"], batch["image"]
        if cfg.use_l1:
            loss["rgb_loss"] = L.l1_loss(pred, target)
        if self.lpips_params is not None:
            ps = cfg.patch_size
            out_p = (pred.reshape(-1, ps, ps, 3) * 2.0 - 1.0).clamp(-1.0, 1.0)
            gt_p = (target.reshape(-1, ps, ps, 3) * 2.0 - 1.0).clamp(-1.0, 1.0)
            loss["lpips_loss"] = cfg.lpips_loss_mult * lpips(self.lpips_params, out_p, gt_p).mean()
        return loss
