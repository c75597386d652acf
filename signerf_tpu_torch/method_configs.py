"""Method registry: `signerf_nerfacto` (ported) and `signerf` (raises).

Port of `signerf_tpu/method_configs.py`, same hyperparameters.
"""

from __future__ import annotations

from typing import Callable, Dict

from signerf_tpu_torch.data.datamanager import SIGNeRFDataManagerConfig
from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig
from signerf_tpu_torch.engine.optimizers import OptimizersConfig
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainerConfig
from signerf_tpu_torch.models.signerf import SIGNeRFModelConfig
from signerf_tpu_torch.pipeline import SIGNeRFPipelineConfig


def signerf_method() -> SIGNeRFTrainerConfig:
    raise NotImplementedError(
        "the `signerf` method (LPIPS patch loss, 32x32 patches, normals) comes with slice 3 "
        "of the port; use signerf_nerfacto"
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
