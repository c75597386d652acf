"""How much pretraining the reference-scale edit pass needs before its edit
masks are non-empty.

examples/north_star_pass_torch.py edits an AABB that clips the top of its
analytic sphere. A reference view's mask holds the pixels whose rendered
depth falls inside the box along their ray, so an under-trained NeRF, whose
depth lies in front of or behind the box, gives an empty mask and nothing
is edited. This script builds the pass's scene, pretrains the `signerf`
method with the pass's own trainer config, and after each listed step count
renders the 8 reference views: each view's mask coverage, and of the rays
that cross the box, the share whose depth lies in front of it and behind
it. The last state can be saved as a checkpoint that the pass loads
(its `load_dir`). Usage, from the repository root, on a card:

    python scripts/probe_edit_mask_torch.py [--views 100] [--size 1024] [--steps 500,1000,2000]
        [--rays 16384] [--out DIR] [--save-checkpoint DIR] [--json FILE] [--device cuda|cpu]

`--rays` sets the rays a pretrain step (the method's 16,384 by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "examples")]

import north_star_pass_torch as ns  # noqa: E402
from signerf_tpu_torch.engine.checkpoints import save_checkpoint  # noqa: E402
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer, SIGNeRFTrainerConfig  # noqa: E402
from signerf_tpu_torch.ops.intersection import intersect_with_aabb  # noqa: E402
from signerf_tpu_torch.render import resolve_device  # noqa: E402


def reference_masks(trainer: SIGNeRFTrainer) -> Dict[str, List[float]]:
    """The reference views' mask coverage, and the shares of box-crossing
    rays whose rendered depth lies in front of and behind the box."""
    dpo = trainer.pipeline.datamanager.outputs
    lo, hi = ns.scene_aabb(dpo.dataparser_transform, dpo.dataparser_scale)
    gen = trainer.pipeline.dataset_generator
    gen.config.aabb_min, gen.config.aabb_max = lo, hi
    cams = gen._cameras_from_poses(ns.reference_poses(dpo.dataparser_transform, dpo.dataparser_scale))
    box = torch.tensor([lo, hi], device=trainer.device)
    out: Dict[str, List[float]] = {"coverage": [], "in_front": [], "behind": []}
    for i in range(len(cams)):
        _, mask, _ = gen.render_camera(cams, i)
        depth = trainer.pipeline.render_camera_fn(cams, i)["depth"]
        rb = cams.generate_rays(camera_index=i)
        near, far = intersect_with_aabb(rb.origins, rb.directions, box)
        crossing = (near < far) & (near > 0)
        n = crossing.sum().clamp_min(1)
        out["coverage"].append(float(mask.mean()))
        out["in_front"].append(float(((depth <= near) & crossing).sum() / n))
        out["behind"].append(float(((depth >= far) & crossing).sum() / n))
    return out


def probe(root: Path, views: int, size: int, steps: Sequence[int], device: torch.device,
          configure: Optional[Callable[[SIGNeRFTrainerConfig], None]] = None, until_filled: bool = False):
    """Pretrain on the pass's scene under `root` and measure the reference
    masks after each count of `steps`; with `until_filled`, stop at the
    first count where every mask is non-empty. Returns (trainer, rows)."""
    data = root / "data"
    if not (data / "transforms.json").exists():
        ns.build_dataset(data, views, size, device)
    cfg = ns.trainer_config(root, data, 0, None)
    cfg.steps_per_save = 1 << 30  # the loop's own saves only at the end of each train()
    if configure is not None:
        configure(cfg)
    trainer = SIGNeRFTrainer(cfg, device)
    trainer.setup()
    rows = []
    for target in steps:
        cfg.max_num_iterations = target
        t0 = time.perf_counter()
        trainer.train()
        if device.type == "cuda":
            torch.cuda.synchronize()
        row = {"views": views, "steps": trainer.step, "train_s": time.perf_counter() - t0, **reference_masks(trainer)}
        print(f"[{views} views] {row['steps']} steps ({row['train_s']:.1f} s): coverage "
              + " ".join(f"{c:.4f}" for c in row["coverage"]) + " | depth in front of the box "
              + " ".join(f"{c:.2f}" for c in row["in_front"]) + " | behind "
              + " ".join(f"{c:.2f}" for c in row["behind"]), flush=True)
        rows.append(row)
        if until_filled and min(row["coverage"]) > 0:
            break
    return trainer, rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=ns.REFERENCE["n_views"])
    ap.add_argument("--size", type=int, default=ns.REFERENCE["size"])
    ap.add_argument("--steps", default="500,1000,2000,3000,4000", help="comma-separated pretrain step counts")
    ap.add_argument("--rays", type=int, default=None, help="rays a pretrain step")
    ap.add_argument("--out", type=Path, default=Path("outputs/probe_edit_mask_torch"))
    ap.add_argument("--save-checkpoint", type=Path, default=None, help="write the last state here")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def rays(cfg):
        if args.rays is not None:
            cfg.pipeline.datamanager.train_num_rays_per_batch = args.rays

    trainer, rows = probe(args.out, args.views, args.size, [int(s) for s in args.steps.split(",")], dev, rays)
    if args.save_checkpoint is not None:
        path = save_checkpoint(args.save_checkpoint, trainer.step, trainer.pipeline.model.state_dict(),
                               trainer.optimizer)
        print(f"saved {path}", flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
