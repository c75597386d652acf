"""A full SIGNeRF edit pass with the PyTorch port, on the card by default:
train -> reference sheet -> per-view regeneration (batched) -> dataset hot
swap -> refinement, with the wall time of each phase.

    python examples/full_edit_pass_torch.py [--device cuda|cpu] [--steps 500] [--size 512]

Run from the repository root. The scene is an analytic sphere seen by 8
cameras; SDXL + ControlNet-depth runs at its published widths with seeded
random weights unless `--sdxl-weights DIR` holds `sdxl_params.pt`, so the
work is real but the edit is not meaningful. Outputs go to
outputs/e2e_demo_torch/. The twin of examples/full_edit_pass.py.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.cameras.cameras import Cameras  # noqa: E402
from signerf_tpu_torch.cameras.poses import circle_poses  # noqa: E402
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer  # noqa: E402
from signerf_tpu_torch.method_configs import signerf_nerfacto_method  # noqa: E402
from signerf_tpu_torch.render import resolve_device  # noqa: E402
from signerf_tpu_torch.utils.images import save_array_png  # noqa: E402

ROOT = Path("outputs/e2e_demo_torch")
N_VIEWS = 8
FOCAL_PER_PX = 600.0 / 512


def analytic_rgb(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    b = (o * d).sum(-1)
    disc = b * b - ((o * o).sum(-1) - 1.0)
    hit = disc > 0
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    p = o + d * t[..., None]
    return torch.where(hit[..., None], p.abs().clamp(0.0, 1.0), torch.ones_like(p))


def write_dataset(data: Path, size: int) -> None:
    (data / "images").mkdir(parents=True, exist_ok=True)
    poses = circle_poses(N_VIEWS, radius=3.0, theta=60.0, phi=(0.0, 315.0))
    focal = FOCAL_PER_PX * size
    frames = []
    for i in range(N_VIEWS):
        cams = Cameras(camera_to_worlds=poses[i : i + 1, :3], fx=torch.tensor([focal]), fy=torch.tensor([focal]),
                       cx=torch.tensor([size / 2]), cy=torch.tensor([size / 2]), width=size, height=size)
        rb = cams.generate_rays(0)
        save_array_png(analytic_rgb(rb.origins, rb.directions).numpy(), data / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
    (data / "transforms.json").write_text(json.dumps({
        "camera_model": "OPENCV", "fl_x": focal, "fl_y": focal, "cx": size / 2, "cy": size / 2, "w": size,
        "h": size, "frames": frames}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=500, help="train and refinement steps each")
    ap.add_argument("--size", type=int, default=512, help="image side in pixels")
    ap.add_argument("--sdxl-weights", default=None, help="directory with sdxl_params.pt")
    args = ap.parse_args()
    device = resolve_device(args.device)
    data = ROOT / f"data_{args.size}"
    if not (data / "transforms.json").exists():
        write_dataset(data, args.size)
        print(f"dataset written to {data}", flush=True)

    cfg = signerf_nerfacto_method()
    cfg.output_dir = ROOT / "out"
    cfg.pipeline.datamanager.dataparser.data = data
    cfg.pipeline.model.far_plane = 8.0
    cfg.max_num_iterations = args.steps
    cfg.steps_per_call = 50
    cfg.steps_per_save = args.steps
    gen = cfg.pipeline.dataset_generator
    gen.path = ROOT / "generations"
    gen.dataset_name = "edit0"
    gen.aabb_min, gen.aabb_max = (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)
    gen.diffuser.prompt = "a stone sphere"
    gen.diffuser.sdxl_weights_path = args.sdxl_weights

    def wall(label, fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.3f} s", flush=True)
        return out

    trainer = SIGNeRFTrainer(cfg, device)
    wall("setup", trainer.setup)
    wall(f"train {args.steps} steps", trainer.train)
    ref = circle_poses(5, radius=3.0, theta=55.0, phi=(0.0, 288.0)).numpy()[:, :3]
    generated = wall(f"dataset generation ({N_VIEWS} views + 5 references)",
                     lambda: trainer.generate_dataset(reference_camera_to_worlds=ref))
    timings = trainer.pipeline.dataset_generator.last_timings
    print(f"  reference sheet {timings['sheet_s']:.3f} s; per-view chunks of {gen.generation_batch_size}: "
          + ", ".join(f"{s:.3f}" for s in timings["view_s"]) + " s", flush=True)
    wall("exchange", lambda: trainer.exchange_training_dataset(generated))
    wall(f"refine {args.steps} steps", trainer.train)
    if device.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
