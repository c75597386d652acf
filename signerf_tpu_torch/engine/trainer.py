"""SIGNeRF trainer: load, (pause), generate, hot-swap the dataset, refine.

Port of `signerf_tpu/engine/trainer.py`: the config and its edit-flow
knobs, `setup`, the initial checkpoint load (surgery, step reset to 0), the
previous experiment's generator config and cameras, `generate_dataset`,
`exchange_training_dataset` (checkpoint, rebuild the pipeline on the
generated dataset, reload without the proposal networks, step 0),
`run_headless`, the train loop with its paused state, and checkpoints.

Scalars are read back to the host every fourth call of the train function,
as in the JAX package, so the loop does not wait on the device otherwise.

`train_lock` (nerfstudio's): each call of the train function, each
checkpoint save of the loop and the dataset exchange hold it, and so does
the viewer around its renders and exports. The optimizer updates the
model in place, so without it a render in another thread could read one
chunk's weights before a step and the next chunk's after it. It is granted
in the order it is asked for: the loop takes it again right after letting
it go, and would starve a waiting viewer under a plain `threading.Lock`.

With a `DataMesh` (one process per card, `parallel/mesh.py`) every rank
runs this loop: rank 0's parameters are broadcast after every build and
reload, each rank samples rays with its own generator (seeded from (seed,
rank)), the train step averages gradients over the ranks, and only rank 0
prints, writes events and config, and writes and prunes checkpoints; a
barrier follows each save, so no rank reads a checkpoint before it is on
disk. A mesh with a tensor axis changes none of this: the NeRF is
data-parallel over all its ranks, and only the generator's SDXL is
sharded over each tensor group (the pipeline hands it the mesh).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Optional

import torch

from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.data.dataparser import load_previous_experiment_cameras
from signerf_tpu_torch.diffusion.diffuser import Diffuser
from signerf_tpu_torch.engine.checkpoints import checkpoint_path, latest_checkpoint, save_checkpoint
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
from signerf_tpu_torch.engine.train_step import make_train_step
from signerf_tpu_torch.engine.writer import EventWriter, RaysPerSecTracker
from signerf_tpu_torch.generator.datasetgenerator import DatasetGeneratorConfig
from signerf_tpu_torch.parallel.mesh import rank_seed
from signerf_tpu_torch.pipeline import SIGNeRFPipeline, SIGNeRFPipelineConfig

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh


class FairLock:
    """A lock that waiting threads get in the order they asked for it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._next = 0  # the ticket the next acquire() draws
        self._serving = 0  # the ticket that holds the lock

    def acquire(self) -> None:
        with self._cond:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cond.wait()

    def release(self) -> None:
        with self._cond:
            self._serving += 1
            self._cond.notify_all()

    def locked(self) -> bool:
        with self._cond:
            return self._serving != self._next

    def __enter__(self) -> "FairLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


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
    mixed_precision: bool = True  # bf16 compute is always on; kept for config parity
    steps_per_call: int = 25  # optimizer steps per call of the train function
    # the edit flow
    skip_interface: bool = False
    skip_generation: bool = False
    previous_experiment_dir: Optional[Path] = None
    generated_dataset_dir: Optional[Path] = None
    load_dir: Optional[Path] = None
    load_checkpoint: Optional[Path] = None
    # Checkpoint loads always restart the optimizer, schedules and step, as
    # in the JAX package; these knobs are kept for config parity.
    reset_optimizer: bool = True
    reset_scheduler: bool = True
    reset_step: bool = True
    use_wandb: bool = False
    seed: int = 42


class _NullWriter:
    """The event writer of ranks other than 0: writes nothing."""

    def write_scalars(self, step, scalars) -> None:
        pass

    def write_config(self, config_text) -> None:
        pass

    def close(self) -> None:
        pass


class SIGNeRFTrainer:
    def __init__(self, config: SIGNeRFTrainerConfig, device: torch.device, mesh: Optional["DataMesh"] = None):
        """`mesh`: this process's rank of a data-parallel group (None: one
        device, no collective)."""
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.training_state = "paused"  # paused | training | completed
        self.train_lock = FairLock()
        self.pipeline: Optional[SIGNeRFPipeline] = None
        self.previous_cameras: Optional[Dict[str, Any]] = None
        self.step = 0
        # A previous experiment's generator config replaces the configured one.
        if config.previous_experiment_dir is not None:
            prev_cfg = Path(config.previous_experiment_dir) / "config.yml"
            if prev_cfg.exists():
                config.pipeline.dataset_generator = cfglib.load_yaml(DatasetGeneratorConfig, prev_cfg)

    @property
    def checkpoint_dir(self) -> Path:
        c = self.config
        return Path(c.output_dir) / c.experiment_name / c.method_name / "checkpoints"

    def setup(self, diffuser: Optional[Diffuser] = None) -> None:
        """Build the pipeline (with `diffuser` as the generator's inpainter,
        or the configured one), the writer, the initial checkpoint and the
        train function."""
        c = self.config
        self.pipeline = SIGNeRFPipeline(c.pipeline, self.device, diffuser=diffuser, seed=c.seed, mesh=self.mesh)
        log_dir = Path(c.output_dir) / c.experiment_name / c.method_name
        if self.is_main:
            self.writer = EventWriter(log_dir, use_wandb=c.use_wandb, run_name=c.experiment_name)
        else:
            self.writer = _NullWriter()
        self.writer.write_config(cfglib.to_yaml(c))
        self.rays_tracker = RaysPerSecTracker()
        self._load_initial_checkpoint()
        self._replicate()
        self._build_train_fn()
        if c.previous_experiment_dir is not None:
            tp = Path(c.previous_experiment_dir) / "transforms.json"
            if tp.exists():
                self.previous_cameras = load_previous_experiment_cameras(tp)

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
            self._print(f"[trainer] loaded checkpoint {ckpt} (step reset to 0)")
        self.step = 0

    def _print(self, *args, **kwargs) -> None:
        if self.is_main:
            print(*args, **kwargs)

    def _replicate(self) -> None:
        """Rank 0's parameters and buffers on every rank."""
        if self.mesh is not None:
            self.mesh.broadcast_module_(self.pipeline.model)

    def _build_train_fn(self) -> None:
        c = self.config
        dm = self.pipeline.datamanager
        self.optimizer = make_optimizer(c.optimizers, self.pipeline.model)
        settings = dm.sampler_settings()
        self._train_fn = make_train_step(
            self.pipeline.model, self.optimizer, dm.cameras, settings, steps_per_call=c.steps_per_call,
            mesh=self.mesh,
        )
        rank = 0 if self.mesh is None else self.mesh.rank
        self._generator = torch.Generator(device=self.device).manual_seed(rank_seed(c.seed, rank))
        self._num_rays_per_call = settings.num_rays * c.steps_per_call  # the global batch

    # ------------------------------------------------------------------
    # dataset generation and hot swap
    # ------------------------------------------------------------------

    def generate_dataset(self, **kwargs) -> Path:
        """The whole dataset generation from the current NeRF weights. By
        default the datamanager's cameras, files and images are the
        originals, and a previous experiment's poses are reused; `kwargs`
        override any `DatasetGenerator.generate_dataset` argument."""
        dm = self.pipeline.datamanager
        defaults: Dict[str, Any] = {}
        if self.previous_cameras is not None:
            defaults["reference_camera_to_worlds"] = self.previous_cameras["reference_camera_to_worlds"]
            if self.previous_cameras["synthetic_camera_to_worlds"] is not None:
                defaults["synthetic_camera_to_worlds"] = self.previous_cameras["synthetic_camera_to_worlds"]
        defaults["original_cameras"] = dm.cameras
        defaults["original_filenames"] = list(dm.outputs.image_filenames)
        defaults.update(kwargs)
        if defaults.get("merge_with_original_dataset") and "original_images" not in defaults:
            defaults["original_images"] = dm.images.float() / 255.0  # read only by the merge
        if defaults.get("reference_camera_to_worlds") is None:
            raise ValueError(
                "the edit flow needs the reference sheet's poses: pass reference_camera_to_worlds, or "
                "--previous-experiment-dir with a generated dataset (its transforms.json)"
            )
        return self.pipeline.dataset_generator.generate_dataset(**defaults)

    def exchange_training_dataset(self, generated_dir: Path) -> None:
        """Train on the generated dataset from now on: checkpoint the current
        weights, rebuild the pipeline on `generated_dir`, reload the
        checkpoint without the proposal networks (they start from the seeded
        init) and reset the step to 0."""
        c = self.config
        with self.train_lock:
            ckpt = self.save_checkpoint()
            c.pipeline.datamanager.dataparser.data = Path(generated_dir)
            diffuser = self.pipeline.dataset_generator.diffuser
            self.pipeline = SIGNeRFPipeline(c.pipeline, self.device, diffuser=diffuser, seed=c.seed, mesh=self.mesh)
            self.pipeline.reload_model_state_dict_without_proposal_weights(ckpt)
            self._replicate()
            self.step = 0
            self._build_train_fn()
        self._print(f"[trainer] exchanged training dataset -> {generated_dir}")

    def run_headless(self, **generate_kwargs) -> None:
        """The `skip_interface` path: generate (unless `skip_generation` with
        a `generated_dataset_dir`), exchange, train."""
        c = self.config
        if c.skip_generation and c.generated_dataset_dir is not None:
            generated = Path(c.generated_dataset_dir)
        else:
            generated = self.generate_dataset(**generate_kwargs)
        self.exchange_training_dataset(generated)
        self.train()

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

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
            if self.training_state == "paused":  # set by an interface's pause button
                time.sleep(0.1)
                continue
            with self.train_lock:
                metrics = self.train_iteration()
            if (self.step // c.steps_per_call) % 4 == 0:
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["rays_per_sec"] = self.rays_tracker.tick(self._num_rays_per_call * 4)
                self.writer.write_scalars(self.step, scalars)
                self._print(
                    f"[train] step {self.step}: loss={scalars['total_loss']:.4f} "
                    f"psnr={scalars['psnr']:.2f} ({scalars['rays_per_sec'] / 1e3:.0f}k rays/s)"
                )
            if self.step % c.steps_per_save < c.steps_per_call:
                with self.train_lock:
                    self.save_checkpoint()
        with self.train_lock:
            self.save_checkpoint()
        self.training_state = "completed"
        self._print(f"[trainer] finished {self.step} steps in {(time.time() - t_start) / 60:.1f} min")

    def save_checkpoint(self) -> Path:
        """Rank 0 writes (and prunes); every rank returns the path once the
        file is on disk."""
        path = checkpoint_path(self.checkpoint_dir, self.step)
        if self.is_main:
            save_checkpoint(self.checkpoint_dir, self.step, self.pipeline.model.state_dict(), self.optimizer)
            if self.config.save_only_latest_checkpoint:
                for old in sorted(self.checkpoint_dir.glob("step-*.pt"))[:-1]:
                    old.unlink()
        if self.mesh is not None:
            self.mesh.barrier()
        return path
