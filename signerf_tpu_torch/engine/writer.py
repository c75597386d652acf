"""Metrics writer and train rays/s tracker.

Port of `signerf_tpu/engine/writer.py`: the JSONL event log and config dump
(wandb when installed and asked for); `GLOBAL_BUFFER`, the latest scalars
and the train rays/s EMA, which the viewer's `/state` shows and its render
throttle reads. The JAX module's profiler hook has no counterpart: the
port's spans (`utils/tracing.py`) record under `torch.profiler`.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

# The latest value of every scalar written, as nerfstudio's writer keeps it.
GLOBAL_BUFFER: Dict[str, float] = {}


class EventWriter:
    def __init__(self, log_dir: Path, use_wandb: bool = False, run_name: str = "run"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.events_path = self.log_dir / "events.jsonl"
        self._fh = open(self.events_path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project="signerf-tpu", name=run_name, dir=str(log_dir))
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def write_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        for k, v in row.items():
            if k not in ("step", "time"):
                GLOBAL_BUFFER[k] = v
        if self._wandb is not None:
            self._wandb.log(row, step=int(step))

    def write_config(self, config_text: str) -> None:
        (self.log_dir / "config.yml").write_text(config_text)

    def close(self) -> None:
        self._fh.close()


class RaysPerSecTracker:
    """EMA of rays/s between ticks, published to GLOBAL_BUFFER as
    train_rays_per_sec."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.value: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, num_rays: int) -> float:
        now = time.time()
        if self._last is not None:
            rate = num_rays / max(now - self._last, 1e-9)
            self.value = rate if self.value is None else self.alpha * rate + (1 - self.alpha) * self.value
            GLOBAL_BUFFER["train_rays_per_sec"] = self.value
        self._last = now
        return self.value or 0.0

