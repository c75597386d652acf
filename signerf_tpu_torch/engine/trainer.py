"""SIGNeRF trainer: load, train, checkpoint.

Port of the training part of `signerf_tpu/engine/trainer.py`: the config,
`setup`, the initial checkpoint load (surgery, step reset to 0), the train
loop and checkpoints. The edit flow (`generate_dataset`,
`exchange_training_dataset`, `run_headless`) comes with the orchestration
slice of the port and raises here, as do its config knobs
(`skip_interface`, `skip_generation`, `previous_experiment_dir`,
`generated_dataset_dir`: unknown keys).

Scalars are read back to the host every fourth call of the train function,
as in the JAX package, so the loop does not wait on the device otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, save_checkpoint
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
from signerf_tpu_torch.engine.train_step import make_train_step
from signerf_tpu_torch.engine.writer import EventWriter, RaysPerSecTracker
from signerf_tpu_torch.pipeline import SIGNeRFPipeline, SIGNeRFPipelineConfig

_EDIT_FLOW = "the edit flow (dataset generation and hot swap) comes with the orchestration slice of the port (slice 6)"


@dataclasses.dataclass
class SIGNeRFTrainerConfig:
    method_name: str = "signerf"
    output_dir: Path = Path("outputs")
    experiment_name: str = "experiment"
    pipeline: SIGNeRFPipelineConfig = dataclasses.field(default_factory=SIGNeRFPipelineConfig)
    optimizers: OptimizersConfig = dataclasses.field(default_factory=OptimizersConfig)
    max_num_iterations: int = 20000
    steps_per_save: int = 1000
    save_only_latest_checkpoint: bool = False
    steps_per_call: int = 25  # optimizer steps per call of the train function
    load_dir: Optional[Path] = None
    load_checkpoint: Optional[Path] = None
    use_wandb: bool = False
    seed: int = 42


def config_text(config) -> str:
    """The config as JSON (which is also YAML), for `config.yml`."""
    return json.dumps(dataclasses.asdict(config), indent=2, default=str)


class SIGNeRFTrainer:
    def __init__(self, config: SIGNeRFTrainerConfig, device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.training_state = "paused"  # paused | training | completed
        self.pipeline: Optional[SIGNeRFPipeline] = None
        self.step = 0

    @property
    def checkpoint_dir(self) -> Path:
        c = self.config
        return Path(c.output_dir) / c.experiment_name / c.method_name / "checkpoints"

    def setup(self) -> None:
        c = self.config
        self.pipeline = SIGNeRFPipeline(c.pipeline, self.device, seed=c.seed)
        log_dir = Path(c.output_dir) / c.experiment_name / c.method_name
        self.writer = EventWriter(log_dir, use_wandb=c.use_wandb, run_name=c.experiment_name)
        self.writer.write_config(config_text(c))
        self.rays_tracker = RaysPerSecTracker()
        self._load_initial_checkpoint()
        self._build_train_fn()

    def _load_initial_checkpoint(self) -> None:
        c = self.config
        ckpt = None
        if c.load_checkpoint is not None:
            ckpt = Path(c.load_checkpoint)
        elif c.load_dir is not None:
            ckpt = latest_checkpoint(Path(c.load_dir))
        if ckpt is not None and ckpt.exists():
            # the step always restarts at 0, as in the reference
            self.pipeline.load_state_dict(ckpt)
            print(f"[trainer] loaded checkpoint {ckpt} (step reset to 0)")
        self.step = 0

    def _build_train_fn(self) -> None:
        c = self.config
        dm = self.pipeline.datamanager
        self.optimizer = make_optimizer(c.optimizers, self.pipeline.model)
        settings = dm.sampler_settings()
        self._train_fn = make_train_step(
            self.pipeline.model, self.optimizer, dm.cameras, settings, steps_per_call=c.steps_per_call
        )
        self._generator = torch.Generator(device=self.device).manual_seed(c.seed)
        self._num_rays_per_call = settings.num_rays * c.steps_per_call

    def generate_dataset(self, **kwargs) -> Path:
        raise NotImplementedError(_EDIT_FLOW)

    def exchange_training_dataset(self, generated_dir: Path) -> None:
        raise NotImplementedError(_EDIT_FLOW)

    def run_headless(self, **generate_kwargs) -> None:
        raise NotImplementedError(_EDIT_FLOW)

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        dm = self.pipeline.datamanager
        metrics = self._train_fn(self.step, dm.images, dm.mask_indices, self._generator)
        self.step += self.config.steps_per_call
        return metrics

    def train(self) -> None:
        c = self.config
        self.training_state = "training"
        t_start = time.time()
        while self.step < c.max_num_iterations:
            metrics = self.train_iteration()
            if (self.step // c.steps_per_call) % 4 == 0:
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["rays_per_sec"] = self.rays_tracker.tick(self._num_rays_per_call * 4)
                self.writer.write_scalars(self.step, scalars)
                print(
                    f"[train] step {self.step}: loss={scalars['total_loss']:.4f} "
                    f"psnr={scalars['psnr']:.2f} ({scalars['rays_per_sec'] / 1e3:.0f}k rays/s)"
                )
            if self.step % c.steps_per_save < c.steps_per_call:
                self.save_checkpoint()
        self.save_checkpoint()
        self.training_state = "completed"
        print(f"[trainer] finished {self.step} steps in {(time.time() - t_start) / 60:.1f} min")

    def save_checkpoint(self) -> Path:
        path = save_checkpoint(
            self.checkpoint_dir, self.step, self.pipeline.model.state_dict(), self.optimizer
        )
        if self.config.save_only_latest_checkpoint:
            for old in sorted(self.checkpoint_dir.glob("step-*.pt"))[:-1]:
                old.unlink()
        return path
