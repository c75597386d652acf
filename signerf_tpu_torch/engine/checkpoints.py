"""Checkpoint save/load with SIGNeRF's selective-restore surgery.

Port of `signerf_tpu/engine/checkpoints.py`. A checkpoint is
`step-{step:09d}.pt`, a `torch.save` of ``{"step", "params": state_dict,
"optimizer": optimizer state}``, read back with `weights_only=True`.

Surgery on load, as the reference does (signerf_pipeline.py:93-144): the
appearance codes and the camera-opt pose adjustments are dropped and come
from the model's own fresh init, and optionally so do all `proposal*`
weights (the dataset hot-swap retrains the proposal networks).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch


def checkpoint_path(directory: Path, step: int) -> Path:
    return Path(directory) / f"step-{step:09d}.pt"


def latest_checkpoint(directory: Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(directory.glob("step-*.pt"))
    return ckpts[-1] if ckpts else None


def save_checkpoint(directory: Path, step: int, params: Dict[str, torch.Tensor], optimizer=None) -> Path:
    """Write host copies of the params (a state_dict) and optimizer state."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    to_cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return to_cpu(tree)

    state = {
        "step": int(step),
        "params": host(dict(params)),
        "optimizer": None if optimizer is None else host(optimizer.state_dict()),
    }
    path = checkpoint_path(directory, step)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    return path


def load_checkpoint(path: Path) -> Dict:
    """{"step", "params", "optimizer"} on the CPU."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def strip_appearance_and_camera_opt(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the appearance codes and camera_opt (signerf_pipeline.py:110-121)."""
    return {
        k: v
        for k, v in params.items()
        if k.split(".")[0] != "camera_opt" and not k.startswith("field.appearance.")
    }


def strip_proposals(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop every top-level `proposal*` entry (signerf_pipeline.py:126-144)."""
    return {k: v for k, v in params.items() if not k.startswith("proposal")}


def merge_with_init(
    loaded: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """The init state_dict with every entry the surgery kept replaced by the
    loaded one (entries the model does not have are ignored)."""
    return {k: loaded.get(k, v) for k, v in init.items()}


def surgical_restore(
    path: Path, init_params: Dict[str, torch.Tensor], drop_proposals: bool = False
) -> Dict[str, torch.Tensor]:
    """Full SIGNeRF restore: load -> strip appearance/camera-opt ->
    optionally strip proposals -> overlay onto the fresh init."""
    loaded = strip_appearance_and_camera_opt(load_checkpoint(path)["params"])
    if drop_proposals:
        loaded = strip_proposals(loaded)
    return merge_with_init(loaded, init_params)
