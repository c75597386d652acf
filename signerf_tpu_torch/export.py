"""Export CLI: `python -m signerf_tpu_torch.export {pointcloud,mesh} --data ... [...]`.

Port of `signerf_tpu/export.py`. `pointcloud` back-projects rendered depth
into a coloured point cloud and writes a binary PLY; the renders are the
chunked eval renders of `make_eval_render` (K1 on the card). `mesh` samples
the base field's density (K1's path) on a grid and extracts an iso-surface
by marching tetrahedra into a watertight OBJ, which can serve as a
shape-mode proxy (`--pipeline.dataset-generator.renderer.object-path`).

Flags:
  --data PATH          dataset (transforms.json or its directory)
  --load-dir PATH      checkpoint directory (newest step-*.pt, else newest JAX
                       step-*.ckpt, through the restore surgery); without it
                       a seeded random init
  --output PATH        output file (default point_cloud.ply / mesh.obj)
  --num-points N       uniform subsample target (default 1_000_000)
  --downscale K        render at 1/K resolution (default 2)
  --min-accumulation A drop rays with opacity below A (default 0.5)
  --bbox-min/--bbox-max "(x,y,z)"  keep points inside this box / sample the
                       mesh grid over it (default: the scene box)
  --resolution N       mesh grid resolution per axis (default 256)
  --iso D              mesh density iso-level (default 15.0); "pNN" takes the
                       NN-th percentile of the sampled densities
  --device DEV         torch device (default cuda); `cuda` without a card raises
  --model.KEY VALUE    model config overrides (must match the checkpoint)
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np
import torch

from signerf_tpu_torch import config as cfglib


def write_ply(path: Path, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY: float32 xyz + uint8 rgb."""
    n = points.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)], align=False))
    rec["xyz"] = points.astype(np.float32)
    rec["rgb"] = colors.astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rec.tobytes())


def read_ply_header(path: Path) -> int:
    """The vertex count of a PLY header."""
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.decode("ascii", "ignore").strip()
            if line.startswith("element vertex"):
                return int(line.split()[-1])
            if line == "end_header":
                break
    return 0


def pointcloud_from_renders(render_fn, cams, aabb, min_accumulation: float = 0.5, num_points: int = 1_000_000,
                            log=print):
    """Back-project rendered depth into (points [N, 3] float32, colours
    [N, 3] uint8). `render_fn(ray_bundle_flat) -> {"rgb", "depth",
    "accumulation"}` is the chunked eval render with its weights bound."""
    h, w = cams.height, cams.width
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    pts_all, rgb_all = [], []
    for i in range(len(cams)):
        flat = cams.generate_rays(camera_index=i, aabb=aabb).reshape((h * w,))
        out = render_fn(flat)
        depth = host(out["depth"]).reshape(-1, 1)
        acc = host(out["accumulation"]).reshape(-1)
        rgb = host(out["rgb"]).reshape(-1, 3)
        o = host(flat.origins).reshape(-1, 3)
        d = host(flat.directions).reshape(-1, 3)
        pts = o + d * depth  # depth is along the ray
        keep = (acc > min_accumulation) & np.isfinite(depth[:, 0])
        pts_all.append(pts[keep])
        rgb_all.append(rgb[keep])
        log(f"camera {i}: kept {int(keep.sum())}/{h * w} rays")
    points = np.concatenate(pts_all, 0)
    colors = np.clip(np.concatenate(rgb_all, 0), 0.0, 1.0) * 255.0
    if points.shape[0] > num_points:
        idx = np.random.RandomState(0).choice(points.shape[0], num_points, replace=False)
        points, colors = points[idx], colors[idx]
    return points, colors.astype(np.uint8)


def mesh_from_density(density_fn, lo: np.ndarray, hi: np.ndarray, resolution: int = 256,
                      iso: "float | str" = 15.0):
    """Sample `density_fn(positions [M, 3] numpy) -> [M]` on a grid over
    [lo, hi] in chunks of 65,536 points (the last padded with zeros) and
    extract the iso-surface with marching tetrahedra. `iso` may be a "pNN"
    percentile string. Returns (verts, faces)."""
    from signerf_tpu_torch.geometry.marching import marching_tetrahedra

    n = int(resolution)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    axes = [np.linspace(lo[a], hi[a], n + 1, dtype=np.float32) for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    chunk = 1 << 16
    gpad = np.pad(grid, ((0, (-grid.shape[0]) % chunk), (0, 0)))
    vals = np.concatenate([np.asarray(density_fn(gpad[i : i + chunk])).reshape(-1)
                           for i in range(0, gpad.shape[0], chunk)])
    vals = vals[: grid.shape[0]].reshape(n + 1, n + 1, n + 1)
    iso_v = float(np.percentile(vals, float(str(iso)[1:]))) if str(iso).startswith("p") else float(iso)
    return marching_tetrahedra(vals, lo, (hi - lo) / n, iso_v)


def density_fn(model, device: torch.device):
    """numpy positions [M, 3] -> the base field's density [M] (numpy)."""

    def fn(positions: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            density, _ = model.field.density(torch.as_tensor(positions, device=device))
        return density.float().cpu().numpy().reshape(-1)

    return fn


def main(argv=None) -> int:
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.geometry.marching import save_obj
    from signerf_tpu_torch.models.signerf import SIGNeRFModelConfig
    from signerf_tpu_torch.pipeline import SURGERY_SEED, seeded_model
    from signerf_tpu_torch.render import resolve_device, restore

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    sub = argv.pop(0)
    if sub not in ("pointcloud", "mesh"):
        print(f"unknown export subcommand {sub!r} (supported: pointcloud, mesh)")
        return 1
    opts = cfglib.parse_cli_overrides(argv)
    data = Path(opts.pop("data"))
    load_dir = opts.pop("load-dir", opts.pop("load_dir", None))
    out_path = Path(opts.pop("output", "point_cloud.ply" if sub == "pointcloud" else "mesh.obj"))
    num_points = int(opts.pop("num-points", opts.pop("num_points", 1_000_000)))
    downscale = int(opts.pop("downscale", 2))
    min_acc = float(opts.pop("min-accumulation", opts.pop("min_accumulation", 0.5)))
    resolution = int(opts.pop("resolution", 256))
    iso_opt = str(opts.pop("iso", "15.0"))
    bbox_min = opts.pop("bbox-min", opts.pop("bbox_min", None))
    bbox_max = opts.pop("bbox-max", opts.pop("bbox_max", None))
    device = resolve_device(opts.pop("device", "cuda"))
    unknown = [k for k in opts if not k.startswith("model.")]
    if unknown:
        raise ValueError(f"unknown flags: {unknown}")
    model_cfg = cfglib.apply_overrides(
        SIGNeRFModelConfig(use_lpips=False), {k.removeprefix("model."): v for k, v in opts.items()}
    )

    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    model = seeded_model(model_cfg, len(parsed.image_filenames), SURGERY_SEED).to(device).eval()
    if load_dir is not None:
        ckpt = latest_checkpoint(Path(load_dir))
        if ckpt is None:
            print(f"no checkpoint under {load_dir}")
            return 1
        restore(model, ckpt)
        print(f"loaded {ckpt}")
    box = None
    if bbox_min is not None and bbox_max is not None:
        box = (np.asarray(ast.literal_eval(str(bbox_min)), np.float32),
               np.asarray(ast.literal_eval(str(bbox_max)), np.float32))

    if sub == "mesh":
        lo, hi = box if box is not None else np.asarray(parsed.scene_box_aabb, np.float32)
        verts, faces = mesh_from_density(density_fn(model, device), lo, hi, resolution, iso_opt)
        if len(faces) == 0:
            print(f"no surface at iso={iso_opt}")
            return 1
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_obj(out_path, verts, faces)
        print(f"wrote {len(verts)} vertices / {len(faces)} faces -> {out_path}")
        return 0

    render = make_eval_render(model, chunk_size=8192)
    cams = parsed.cameras.to(device)
    if downscale > 1:
        cams = cams.rescaled(1.0 / downscale)
    aabb = torch.as_tensor(parsed.scene_box_aabb, device=device)
    points, colors = pointcloud_from_renders(
        lambda flat: render(flat, appearance_mode="index"), cams, aabb, min_accumulation=min_acc,
        num_points=num_points,
    )
    if box is not None:
        inside = ((points >= box[0]) & (points <= box[1])).all(axis=1)
        points, colors = points[inside], colors[inside]
    if points.shape[0] == 0:
        print("no points survived filtering")
        return 1
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_ply(out_path, points, colors)
    print(f"wrote {points.shape[0]} points -> {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
