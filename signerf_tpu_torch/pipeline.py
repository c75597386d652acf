"""SIGNeRF pipeline: the datamanager, the model, the dataset generator and
checkpoint surgery.

Port of `signerf_tpu/pipeline.py`: the generator gets the dataparser's
transform and scale and its inverse-pose callback, its intrinsics come from
the first train camera, and its render hook is `render_camera_fn`, the
chunked full-frame eval render (K1 on the card).

With a `DataMesh`, the generator deals its per-view work over the ranks
(each rank renders its own views), so `render_camera_fn` stays the
one-rank render; the render and eval CLIs split a frame over the ranks
with `make_eval_render(..., mesh=...)`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional

import torch

from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager, SIGNeRFDataManagerConfig
from signerf_tpu_torch.diffusion.diffuser import Diffuser
from signerf_tpu_torch.engine.checkpoints import surgical_restore
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.generator.datasetgenerator import DatasetGenerator, DatasetGeneratorConfig
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

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
    dataset_generator: DatasetGeneratorConfig = dataclasses.field(default_factory=DatasetGeneratorConfig)


class SIGNeRFPipeline:
    def __init__(
        self,
        config: SIGNeRFPipelineConfig,
        device: torch.device,
        diffuser: Optional[Diffuser] = None,
        seed: int = 42,
        mesh: Optional["DataMesh"] = None,
    ):
        """`diffuser`: the generator's inpainter (None: the configured one,
        built on `device`). `mesh`: the data-parallel group the generator
        deals its views over (None: one device)."""
        self.config = config
        self.device = torch.device(device)
        self.datamanager = SIGNeRFDataManager(config.datamanager, self.device)
        self.model = seeded_model(config.model, self.datamanager.num_images, seed).to(self.device)
        self._render = make_eval_render(self.model, chunk_size=min(config.model.eval_num_rays_per_chunk, 8192))
        outputs = self.datamanager.outputs
        if diffuser is None:
            diffuser = Diffuser(config.dataset_generator.diffuser, device=self.device)
        self.dataset_generator = DatasetGenerator(
            config.dataset_generator,
            original_transform_matrix=outputs.dataparser_transform,
            original_scale_factor=outputs.dataparser_scale,
            transform_poses_to_original_space=outputs.transform_poses_to_original_space,
            render_fn=self.render_camera_fn,
            diffuser=diffuser,
            device=self.device,
            mesh=mesh,
        )
        self.dataset_generator.backfill_intrinsics(self.datamanager.cameras)

    def render_camera_fn(self, cameras: Cameras, index: int) -> Dict[str, torch.Tensor]:
        """Full-frame render -> {"rgb" [H, W, 3], "depth" [H, W, 1],
        "accumulation" [H, W, 1]} (the generator's `render_fn`). The
        datamanager's own cameras render with their appearance codes, novel
        poses with the mean code."""
        aabb = torch.as_tensor(self.datamanager.outputs.scene_box_aabb, device=self.device)
        rb = cameras.generate_rays(camera_index=index, aabb=aabb)
        h, w = cameras.height, cameras.width
        mode = "index" if cameras is self.datamanager.cameras else "mean"
        out = self._render(rb.reshape((h * w,)), appearance_mode=mode)
        return {
            "rgb": out["rgb"].reshape(h, w, 3),
            "depth": out["depth"].reshape(h, w, 1),
            "accumulation": out["accumulation"].reshape(h, w, 1),
        }

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
