"""Render CLI: `python -m signerf_tpu_torch.render --data ... [--load-dir ...]`.

Port of `signerf_tpu/render.py`. Renders RGB and depth for the dataset's
cameras, or for a circle of cameras, and writes PNGs.

Flags:
  --data PATH          dataset (transforms.json or its directory)
  --load-dir PATH      checkpoint directory; the newest step-*.pt written by
                       the port's trainer (else the newest step-*.ckpt of
                       the JAX package) is loaded through the restore
                       surgery (engine/checkpoints.py)
  --output PATH        output directory (default renders/)
  --arc N              render an N-camera circle instead of the dataset cameras
  --arc-radius R --arc-theta T
  --downscale K        render at 1/K resolution
  --depth true         also write inverted-depth visualizations
  --device DEV         torch device (default cuda); `cuda` without a card raises
  --mesh SPEC          auto (default) | none | data | data=K | production |
                       data=K,tensor=T | tensor=T, as the train CLI's: more
                       than one card splits each frame's chunks over all
                       the cards, whatever the shape (one process a card,
                       self-spawned or under torchrun); rank 0 writes the
                       PNGs
  --model.KEY VALUE    NerfactoModelConfig overrides, e.g.
                       --model.encoding-backend hash (must match the checkpoint)

Without --load-dir the weights are a seeded random init. With it, the
appearance codes and camera-opt come from that init and everything else
from the checkpoint, as in the JAX CLI. Rays are rendered in chunks of
8192.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Iterator, Optional

import numpy as np
import torch

from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.cameras.poses import circle_poses
from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, surgical_restore
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from signerf_tpu_torch.parallel import mesh as mesh_lib
from signerf_tpu_torch.utils import tracing
from signerf_tpu_torch.utils.images import save_array_png

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

CHUNK_SIZE = 8192
INIT_SEED = 0


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device (pass --device cpu)")
    return device


def restore(model: torch.nn.Module, path: Path) -> None:
    """Load a `step-*.pt` (or JAX `step-*.ckpt`) checkpoint through the
    restore surgery: the appearance codes and camera-opt stay the model's
    own seeded init (as `surgical_restore` in the JAX package and the
    reference do), every other tensor comes from the checkpoint."""
    model.load_state_dict(surgical_restore(path, model.state_dict()), strict=True)


def build_model(
    model_cfg: NerfactoModelConfig, num_images: int, device: torch.device, seed: int = INIT_SEED
) -> NerfactoModel:
    model = NerfactoModel(model_cfg, num_train_images=num_images)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def arc_cameras(cams: Cameras, n: int, radius: float, theta: float) -> Cameras:
    """An n-camera circle with the intrinsics of camera 0, centered principal point."""
    poses = circle_poses(n, radius=radius, theta=theta, phi=(0.0, 360.0 * (n - 1) / n))
    return Cameras(
        camera_to_worlds=poses[:, :3, :].to(cams.device),
        fx=cams.fx[:1].expand(n).clone(),
        fy=cams.fy[:1].expand(n).clone(),
        cx=torch.full((n,), cams.width / 2.0, device=cams.device),
        cy=torch.full((n,), cams.height / 2.0, device=cams.device),
        width=cams.width,
        height=cams.height,
    )


def render_cameras(
    model: NerfactoModel, cams: Cameras, aabb: torch.Tensor, chunk_size: int = CHUNK_SIZE,
    mesh: Optional["DataMesh"] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Each camera's eval outputs, reshaped to [H, W, C], on the model's
    device (with `mesh`, every rank's chunks of each frame, the whole
    frame on every rank)."""
    render = make_eval_render(model, chunk_size=chunk_size, mesh=mesh)
    h, w = cams.height, cams.width
    for i in range(len(cams)):
        with tracing.span("render.frame"):
            out = render(cams.generate_rays(camera_index=i, aabb=aabb).reshape((h * w,)))
            frame = {k: v.reshape(h, w, -1) for k, v in out.items()}
        yield frame


def depth_image(depth: np.ndarray) -> np.ndarray:
    """Inverted, min-max normalized depth visualization in [0, 1]."""
    d = depth - depth.min()
    return 1.0 - d / max(d.max(), 1e-6)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = cfglib.parse_cli_overrides(argv)
    data = Path(opts.pop("data"))
    load_dir = opts.pop("load-dir", opts.pop("load_dir", None))
    out_dir = Path(opts.pop("output", "renders"))
    arc = int(opts.pop("arc", 0))
    arc_radius = float(opts.pop("arc-radius", opts.pop("arc_radius", 1.0)))
    arc_theta = float(opts.pop("arc-theta", opts.pop("arc_theta", 70.0)))
    downscale = int(opts.pop("downscale", 1))
    want_depth = str(opts.pop("depth", "true")).lower() in ("1", "true", "yes")
    device = resolve_device(opts.pop("device", "cuda"))
    mesh_spec = opts.pop("mesh", "auto")
    unknown = [k for k in opts if not k.startswith("model.")]
    if unknown:
        raise ValueError(f"unknown flags: {unknown}")
    model_cfg = cfglib.apply_overrides(
        NerfactoModelConfig(), {k.removeprefix("model."): v for k, v in opts.items()}
    )
    args = (data, load_dir, out_dir, arc, arc_radius, arc_theta, downscale, want_depth, device, model_cfg)
    return mesh_lib.run(mesh_spec, device, out_dir, _render_all, args)


def _render_all(mesh, data, load_dir, out_dir, arc, arc_radius, arc_theta, downscale, want_depth, device,
                model_cfg) -> int:
    """One rank's part of the render CLI (`mesh` None: the one-device run)."""
    if mesh is not None:
        device = mesh.device
    log = print if mesh is None else mesh.print
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    model = build_model(model_cfg, len(parsed.image_filenames), device)
    if load_dir is not None:
        ckpt = latest_checkpoint(Path(load_dir))
        if ckpt is None:
            print(f"no checkpoint under {load_dir}")
            return 1
        restore(model, ckpt)
        log(f"loaded {ckpt}")
    if mesh is not None:
        mesh.broadcast_module_(model)

    cams = parsed.cameras.to(device)
    if downscale > 1:
        cams = cams.rescaled(1.0 / downscale)
    if arc > 0:
        cams = arc_cameras(cams, arc, arc_radius, arc_theta)
    aabb = torch.as_tensor(parsed.scene_box_aabb, device=device)

    out_dir.mkdir(parents=True, exist_ok=True)
    for i, out in enumerate(render_cameras(model, cams, aabb, mesh=mesh)):
        if mesh is None or mesh.is_main:
            save_array_png(out["rgb"].cpu().numpy(), out_dir / f"rgb_{i:05d}.png")
            if want_depth:
                depth = depth_image(out["depth"][..., 0].cpu().numpy())
                save_array_png(depth[..., None], out_dir / f"depth_{i:05d}.png")
        log(f"rendered {i + 1}/{len(cams)}")
    log(f"wrote {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
