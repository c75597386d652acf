"""Method registry: `signerf` (high quality) and `signerf_nerfacto` (fast).

Port of `signerf_tpu/method_configs.py`, same hyperparameters.
"""

from __future__ import annotations

from typing import Callable, Dict

from signerf_tpu_torch.data.datamanager import SIGNeRFDataManagerConfig
from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig
from signerf_tpu_torch.engine.optimizers import OptimizerGroupConfig, OptimizersConfig
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainerConfig
from signerf_tpu_torch.models.signerf import SIGNeRFModelConfig
from signerf_tpu_torch.pipeline import SIGNeRFPipelineConfig


def signerf_method() -> SIGNeRFTrainerConfig:
    """signerf_config.py: 16,384 rays as 32x32 patches, L1 + LPIPS patch
    loss, predicted and gradient normals with their losses."""
    group = dict(lr=1e-2, eps=1e-15, lr_final=1e-4, max_steps=200_000)
    return SIGNeRFTrainerConfig(
        method_name="signerf",
        steps_per_save=1000,
        max_num_iterations=20000,
        save_only_latest_checkpoint=False,
        pipeline=SIGNeRFPipelineConfig(
            datamanager=SIGNeRFDataManagerConfig(
                dataparser=SIGNeRFDataParserConfig(),
                train_num_rays_per_batch=16384,
                patch_size=32,
            ),
            model=SIGNeRFModelConfig(
                predict_normals=True,
                use_lpips=True,
                use_l1=True,
                patch_size=32,
                average_init_density=0.01,
            ),
        ),
        optimizers=OptimizersConfig(
            proposal_networks=OptimizerGroupConfig(**group),
            fields=OptimizerGroupConfig(**group),
            camera_opt=OptimizerGroupConfig(lr=1e-15, eps=1e-15, lr_final=None),
        ),
    )


def signerf_nerfacto_method() -> SIGNeRFTrainerConfig:
    """signerf_nerfacto_config.py: MSE rgb loss, no LPIPS or patches."""
    return SIGNeRFTrainerConfig(
        method_name="signerf_nerfacto",
        steps_per_save=1000,
        max_num_iterations=30000,
        save_only_latest_checkpoint=False,
        pipeline=SIGNeRFPipelineConfig(
            datamanager=SIGNeRFDataManagerConfig(
                dataparser=SIGNeRFDataParserConfig(),
                train_num_rays_per_batch=4096,
                patch_size=1,
            ),
            model=SIGNeRFModelConfig(
                use_lpips=False,
                use_l1=False,
                predict_normals=False,
            ),
        ),
        optimizers=OptimizersConfig(),
    )


METHODS: Dict[str, Callable[[], SIGNeRFTrainerConfig]] = {
    "signerf": signerf_method,
    "signerf_nerfacto": signerf_nerfacto_method,
}
