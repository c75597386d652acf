"""What the NeRF drivers share: the seeded scene and weights, the program's
model and optimizer built from a configuration file, and the comparison
arithmetic."""

from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Dict

import torch

from harness import manifest, scene as scene_lib
from reference import nerf


@dataclasses.dataclass
class Scene:
    poses: torch.Tensor  # [n, 3, 4] camera-to-world
    focal: float
    images: torch.Tensor  # [n, size, size, 3] uint8


def make_scene(tr: Dict, device) -> Scene:
    return Scene(*scene_lib.make_views(tr["views"], tr["size"], device, tr["theta_deg"]))


def traffic(cell: manifest.Cell, hooks) -> Dict:
    t = dict(cell.traffic)
    if hooks is not None:
        t.update(getattr(hooks, "traffic", {}))
    return t


def model_section(cell: manifest.Cell, hooks) -> Dict:
    m = dict(cell.config["model"])
    if hooks is not None:
        m.update(getattr(hooks, "model", {}))
    return m


def device_of(hooks) -> torch.device:
    return torch.device(getattr(hooks, "device", "cuda") if hooks is not None else "cuda")


def limits(cell: manifest.Cell, hooks) -> Dict[str, float]:
    if hooks is not None and getattr(hooks, "limits", None) is not None:
        return hooks.limits
    return json.loads((manifest.BENCH_DIR / "limits" / f"{cell.name}.json").read_text())["limits"]


def program_model(model: Dict, num_images: int):
    from signerf_tpu_torch.models.nerfacto import ProposalNetArgs
    from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig

    known = {f.name for f in dataclasses.fields(SIGNeRFModelConfig)}
    kw = {k: v for k, v in model.items() if k in known}
    kw["num_proposal_samples_per_ray"] = tuple(model["num_proposal_samples_per_ray"])
    kw["proposal_net_args_list"] = tuple(ProposalNetArgs(**a) for a in model["proposal_net_args_list"])
    return SIGNeRFModel(SIGNeRFModelConfig(**kw), num_train_images=num_images)


def program_optimizer(optim: Dict, model):
    from signerf_tpu_torch.engine.optimizers import OptimizerGroupConfig, OptimizersConfig, make_optimizer

    groups = {g: OptimizerGroupConfig(**optim[g]) for g in ("fields", "proposal_networks", "camera_opt")}
    return make_optimizer(OptimizersConfig(**groups, appearance_weight_decay=optim["appearance_weight_decay"]),
                          model)


def program_cameras(scene: Scene):
    from signerf_tpu_torch.cameras.cameras import Cameras

    n, size, dev = scene.images.shape[0], scene.images.shape[1], scene.images.device
    full = lambda v: torch.full((n,), float(v), device=dev)  # noqa: E731
    return Cameras(camera_to_worlds=scene.poses, fx=full(scene.focal), fy=full(scene.focal), cx=full(size / 2),
                   cy=full(size / 2), width=size, height=size)


def seeded_weights(model: Dict, num_images: int, seed: int, device):
    """(shapes, the NeRF's weights, LPIPS's or None), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = nerf.param_shapes(model, num_images)
    weights = nerf.init_params(shapes, gen, device)
    lp = nerf.init_lpips(gen, device) if model.get("use_lpips", False) else None
    return shapes, weights, lp


def load_into_program(model, shapes, weights, lp) -> None:
    from signerf_tpu_torch.ops.lpips import LPIPSParams

    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if have != {k: tuple(v) for k, v in shapes.items()}:
        raise RuntimeError("the program's parameters differ from the configuration's: "
                           f"{sorted(set(have.items()) ^ set(shapes.items()))[:8]}")
    model.load_state_dict(weights, strict=True)
    if lp is not None:
        model.lpips_params = LPIPSParams(convs=[{k: v.clone() for k, v in c.items()} for c in lp["convs"]],
                                         lins=[w.clone() for w in lp["lins"]], net="alex")


def rel_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else float("inf")


def widest_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The widest gap between a leaf's norm on the two sides, against the
    larger of the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[n] for n in keep)
    return max(rel_gap(prog[n], ref[n], max(ref[n], med)) for n in keep)
