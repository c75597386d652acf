"""SIGNeRF pipeline: the datamanager, the model and checkpoint surgery.

Port of the datamanager, model, init and surgery part of
`signerf_tpu/pipeline.py`. The dataset generator and its render hook (the
edit flow) come with the orchestration slice of the port.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
import torch

from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager, SIGNeRFDataManagerConfig
from signerf_tpu_torch.engine.checkpoints import surgical_restore
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig

# Seed of the fresh init that surgery fills dropped entries from (the JAX
# package's PRNGKey(0)); render.py and eval.py build their models with it.
SURGERY_SEED = 0


def seeded_model(config: SIGNeRFModelConfig, num_images: int, seed: int) -> SIGNeRFModel:
    model = SIGNeRFModel(config, num_train_images=num_images)
    return model.reset_parameters(torch.Generator().manual_seed(seed))


@dataclasses.dataclass
class SIGNeRFPipelineConfig:
    datamanager: SIGNeRFDataManagerConfig = dataclasses.field(
        default_factory=SIGNeRFDataManagerConfig
    )
    model: SIGNeRFModelConfig = dataclasses.field(default_factory=SIGNeRFModelConfig)


class SIGNeRFPipeline:
    def __init__(self, config: SIGNeRFPipelineConfig, device: torch.device, seed: int = 42):
        self.config = config
        self.device = torch.device(device)
        self.datamanager = SIGNeRFDataManager(config.datamanager, self.device)
        self.model = seeded_model(config.model, self.datamanager.num_images, seed).to(self.device)

    def _restore(self, ckpt_path: Path, drop_proposals: bool) -> None:
        fresh = seeded_model(self.config.model, self.datamanager.num_images, SURGERY_SEED)
        params = surgical_restore(ckpt_path, fresh.state_dict(), drop_proposals=drop_proposals)
        self.model.load_state_dict(params, strict=True)

    def load_state_dict(self, ckpt_path: Path) -> None:
        """Load nerfacto weights, dropping appearance codes and camera-opt."""
        self._restore(ckpt_path, drop_proposals=False)

    def reload_model_state_dict_without_proposal_weights(self, ckpt_path: Path) -> None:
        """The same, also dropping every proposal network."""
        self._restore(ckpt_path, drop_proposals=True)
