"""SIGNeRF model: nerfacto with an L1 or MSE rgb loss.

Port of `signerf_tpu/models/signerf.py` for the `signerf_nerfacto` method
(`use_lpips=False`). The LPIPS patch loss of the `signerf` method comes with
that method's slice; asking for it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from signerf_tpu_torch.models import losses as L
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig


@dataclasses.dataclass
class SIGNeRFModelConfig(NerfactoModelConfig):
    """The JAX package's rgb-loss knobs and defaults (the defaults are the
    `signerf` method's; `signerf_nerfacto` turns LPIPS and L1 off). The
    LPIPS and patch knobs come with the `signerf` method's slice."""

    use_lpips: bool = True
    use_l1: bool = True


class SIGNeRFModel(NerfactoModel):
    """Nerfacto with SIGNeRF's rgb loss."""

    config: SIGNeRFModelConfig

    def __init__(self, config: SIGNeRFModelConfig, num_train_images: int):
        if config.use_lpips:
            raise NotImplementedError(
                "use_lpips=True: the LPIPS patch loss comes with the `signerf` method's "
                "slice of the port (slice 3); pass --pipeline.model.use-lpips False"
            )
        super().__init__(config, num_train_images)

    def loss_dict(
        self, outputs: Dict[str, Any], batch: Dict[str, torch.Tensor], train: bool = True
    ) -> Dict[str, torch.Tensor]:
        loss = super().loss_dict(outputs, batch, train)
        if self.config.use_l1:
            loss["rgb_loss"] = L.l1_loss(outputs["rgb"], batch["image"])
        return loss
