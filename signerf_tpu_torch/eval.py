"""Eval CLI: `python -m signerf_tpu_torch.eval --data ... --load-dir ...`.

Port of `signerf_tpu/eval.py`: renders every dataset camera with its own
appearance code from a checkpoint (loaded through the restore surgery) and
writes PSNR, SSIM and (with `--lpips true`) LPIPS against the ground-truth
images as a JSON summary.

Flags: --data PATH, --load-dir PATH (its newest step-*.pt, else its newest
JAX step-*.ckpt), --output PATH (default eval.json), --device DEV (default
cuda), --lpips true|false, --lpips-weights PATH.npz (without it LPIPS is a
random-feature distance and a warning says so), --mesh auto|none|data|data=K|
production|data=K,tensor=T|tensor=T (as the train CLI's: more than one card
splits each frame's chunks over all the cards, whatever the shape; rank 0
scores and writes), --model.KEY VALUE (SIGNeRFModelConfig,
e.g. --model.encoding-backend hash).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager, SIGNeRFDataManagerConfig
from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig
from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, surgical_restore
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.models.signerf import SIGNeRFModelConfig
from signerf_tpu_torch.ops import lpips as lp
from signerf_tpu_torch.ops.image_metrics import psnr, ssim
from signerf_tpu_torch.parallel import mesh as mesh_lib
from signerf_tpu_torch.pipeline import SURGERY_SEED, seeded_model
from signerf_tpu_torch.render import resolve_device
from signerf_tpu_torch.utils.calibration import warn_uncalibrated


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = cfglib.parse_cli_overrides(argv)
    data = Path(opts.pop("data"))
    load_dir = opts.pop("load-dir", opts.pop("load_dir", None))
    out_path = Path(opts.pop("output", "eval.json"))
    use_lpips = str(opts.pop("lpips", "false")).lower() in ("1", "true", "yes")
    lpips_weights = opts.pop("lpips-weights", opts.pop("lpips_weights", None))
    device = resolve_device(opts.pop("device", "cuda"))
    mesh_spec = opts.pop("mesh", "auto")
    unknown = [k for k in opts if not k.startswith("model.")]
    if unknown:
        raise ValueError(f"unknown flags: {unknown}")
    model_cfg = cfglib.apply_overrides(
        SIGNeRFModelConfig(use_lpips=False), {k.removeprefix("model."): v for k, v in opts.items()}
    )
    args = (data, load_dir, out_path, use_lpips, lpips_weights, device, model_cfg)
    return mesh_lib.run(mesh_spec, device, out_path.resolve().parent, _evaluate, args)


def _evaluate(mesh, data, load_dir, out_path, use_lpips, lpips_weights, device, model_cfg) -> int:
    """One rank's part of the eval CLI (`mesh` None: the one-device run)."""
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.is_main

    dm = SIGNeRFDataManager(
        SIGNeRFDataManagerConfig(dataparser=SIGNeRFDataParserConfig(data=data)), device
    )
    model = seeded_model(model_cfg, dm.num_images, SURGERY_SEED)
    if load_dir is not None:
        ckpt = latest_checkpoint(Path(load_dir))
        if ckpt is None:
            print(f"no checkpoint under {load_dir}")
            return 1
        model.load_state_dict(surgical_restore(ckpt, model.state_dict()), strict=True)
        if main:
            print(f"loaded {ckpt}")
    model = model.to(device).eval()
    if mesh is not None:
        mesh.broadcast_module_(model)

    lpips_params = None
    if use_lpips and main:
        lp.full_f32_convolutions()
        if lpips_weights:
            lpips_params = lp.load_weights(lpips_weights)
        else:
            warn_uncalibrated(
                "LPIPS",
                "the reported 'lpips' column is a random-feature distance, NOT calibrated LPIPS; "
                "pass --lpips-weights PATH.npz (scripts/export_lpips_weights.py) for real numbers.",
            )
            lpips_params = lp.init_lpips(torch.Generator().manual_seed(0))
        lpips_params = lpips_params.map(lambda t: t.to(device))

    render = make_eval_render(model, chunk_size=8192, mesh=mesh)
    cams = dm.cameras
    h, w = cams.height, cams.width
    aabb = torch.as_tensor(dm.outputs.scene_box_aabb, device=device)
    rows = []
    for i in range(len(cams)):
        rb = cams.generate_rays(camera_index=i, aabb=aabb)
        out = render(rb.reshape((h * w,)), appearance_mode="index")
        if not main:
            continue
        pred = out["rgb"].reshape(h, w, 3)
        gt = dm.images[i].float() / 255.0
        row = {"camera": i, "psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt))}
        if lpips_params is not None:
            with torch.inference_mode():
                row["lpips"] = float(lp.lpips(lpips_params, pred[None] * 2.0 - 1.0, gt[None] * 2.0 - 1.0)[0])
        rows.append(row)
        print(f"camera {i}: psnr={row['psnr']:.2f} ssim={row['ssim']:.4f}")
    if not main:
        return 0

    summary = {
        "num_images": len(rows),
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "per_image": rows,
    }
    if lpips_params is not None:
        summary["lpips"] = float(np.mean([r["lpips"] for r in rows]))
    out_path.write_text(json.dumps(summary, indent=2))
    print(f"mean psnr={summary['psnr']:.2f} ssim={summary['ssim']:.4f} -> {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
