"""Fit the full-size nerfacto to an analytic scene with the PyTorch port.

The port's standard verification drive, the twin of
examples/fit_synthetic.py: it runs the public training API end to end
(`make_train_step`, `make_eval_render`) and prints the parameter count, the
loss and PSNR trajectory, train rays/s and an eval render's PSNR. Usage,
from the repository root:

    python examples/fit_synthetic_torch.py [num_dispatches] [rays_per_batch] [--device cuda|cpu]

A dispatch is 50 optimizer steps, as one `steps_per_call` dispatch of the
JAX script. Times are CUDA events around the dispatches; `--device cuda`
(the default) raises when torch sees no card.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path
from typing import Dict, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.cameras.cameras import Cameras  # noqa: E402
from signerf_tpu_torch.cameras.poses import circle_poses  # noqa: E402
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer  # noqa: E402
from signerf_tpu_torch.engine.train_step import SamplerSettings, make_eval_render, make_train_step  # noqa: E402
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig  # noqa: E402
from signerf_tpu_torch.render import resolve_device  # noqa: E402

STEPS_PER_DISPATCH = 50
VIEWS, SIZE, FOCAL = 16, 128, 160.0


def analytic_rgb(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unit sphere at the origin shaded by |hit point|, white background."""
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    p = o + d * t[..., None]
    return torch.where(hit[..., None], p.abs(), torch.ones_like(p))


def scene(device: torch.device) -> Tuple[Cameras, torch.Tensor]:
    """The 16 cameras of 128 px on a ring and their uint8 images [16, H, W, 3]."""
    poses = circle_poses(VIEWS, radius=3.0, theta=60.0, phi=(0.0, 337.5))[:, :3, :]
    full = lambda v: torch.full((VIEWS,), float(v))  # noqa: E731
    cams = Cameras(camera_to_worlds=poses, fx=full(FOCAL), fy=full(FOCAL), cx=full(SIZE / 2), cy=full(SIZE / 2),
                   width=SIZE, height=SIZE).to(device)
    images = []
    for i in range(VIEWS):
        rb = cams.generate_rays(camera_index=i)
        images.append((analytic_rgb(rb.origins, rb.directions) * 255).to(torch.uint8))
    return cams, torch.stack(images)


def main(calls: int = 20, num_rays: int = 4096, device: str = "cuda") -> Dict[str, object]:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = NerfactoModelConfig(far_plane=6.0, use_appearance_embedding=False)
    model = NerfactoModel(cfg, num_train_images=VIEWS).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    params = sum(p.numel() for p in model.parameters())
    print(f"params: {params / 1e6:.2f}M", flush=True)

    cams, images = scene(dev)
    opt = make_optimizer(OptimizersConfig(), model)
    step_fn = make_train_step(model, opt, cams, SamplerSettings(num_rays=num_rays), steps_per_call=STEPS_PER_DISPATCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 2)] if cuda else []
    trajectory = []
    if cuda:
        events[0].record()
    m = step_fn(0, images, None, gen)
    if cuda:
        events[1].record()
    for i in range(calls):
        m = step_fn((i + 1) * STEPS_PER_DISPATCH, images, None, gen)
        if cuda:
            events[i + 2].record()
        if i % 5 == 4:
            step = (i + 2) * STEPS_PER_DISPATCH
            trajectory.append((step, float(m["total_loss"]), float(m["psnr"])))
            print(f"  step {step}: loss={trajectory[-1][1]:.4f} psnr={trajectory[-1][2]:.2f}", flush=True)
    rays_per_s = first_s = float("nan")
    if cuda:
        torch.cuda.synchronize()
        first_s = events[0].elapsed_time(events[1]) / 1e3
        dt = events[1].elapsed_time(events[-1]) / 1e3
        rays_per_s = calls * STEPS_PER_DISPATCH * num_rays / dt if calls and dt > 0 else float("nan")
        print(f"first dispatch (kernel build and warm-up): {first_s:.1f}s", flush=True)
        print(f"train: {rays_per_s / 1e3:.0f}k rays/s", flush=True)

    model.eval()
    render = make_eval_render(model, chunk_size=8192)
    rb = cams.generate_rays(camera_index=0)
    out = render(rb.reshape((SIZE * SIZE,)))
    target = analytic_rgb(rb.origins, rb.directions)
    mse = float(((out["rgb"].reshape(SIZE, SIZE, 3) - target) ** 2).mean())
    psnr = -10 * math.log10(max(mse, 1e-12))
    print(f"eval PSNR: {psnr:.2f} dB", flush=True)
    return {"params": params, "trajectory": trajectory, "first_dispatch_s": first_s, "train_rays_per_s": rays_per_s,
            "eval_psnr_db": psnr, "steps": (calls + 1) * STEPS_PER_DISPATCH,
            "eval_chunks": -(-SIZE * SIZE // 8192)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num_dispatches", nargs="?", type=int, default=20)
    ap.add_argument("rays_per_batch", nargs="?", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.num_dispatches, args.rays_per_batch, args.device)
