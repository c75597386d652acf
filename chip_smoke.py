#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, one line each (any failure exits
non-zero before the result line):

  1. environment: card name and power limit, torch / CUDA / nvcc versions,
     image libraries present;
  2. build K1 (signerf_tpu_torch/csrc/fused_factor_density.cu) with nvcc;
  3. K1 against its plain PyTorch twin on the card, at the three density
     schedules, at N = 2^21 and at the sample counts of one 8192-ray render
     chunk, plus N = 257 with u in {0, 1}: error and CUDA-event times;
  4. the render CLI at the full width of `signerf_nerfacto` on a synthetic
     512x512 scene (--arc 2 --device cuda, seeded random weights): K1's
     launches must be 3 x chunks; the PNGs must equal a direct render's
     output; outputs finite, accumulation in [0, 1]; rays/s; then one chunk
     again with the plain twin in place of the kernel;
  5. a JSON line per kernel, then {"ok": true, "device": {...}} last.

The script imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Kernel vs plain twin: same contract, but FMA contraction and summation
# order can flip a bf16 rounding of a layer output (1/256 relative), which
# layer 1 carries on: allow 2% of the output range (the TPU kernel's bound
# in tests/test_fused_factor.py).
KERNEL_TOL = 0.02
# One render chunk, kernel vs plain twin: a flipped density rounding moves
# the resampled proposals a little; rgb and accumulation are in [0, 1].
CHUNK_TOL = 0.02
CHUNK = 8192
SCENE = dict(cameras=8, width=512, height=512, arc=2)
RENDER_REPEATS = 5  # warm passes over the arc for the rays/s median


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def read_png(path: Path):
    """Decode an 8-bit PNG with filter type 0 on every row, as the port's
    writer produces (gray or RGB)."""
    import numpy as np

    data = path.read_bytes()
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            channels = {0: 1, 2: 3}[color]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        fail(f"{path.name}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, channels)


def phase_environment(torch) -> str:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    print(card)  # the card's name and power limit, as nvidia-smi gives them
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    nvcc = run([ffc.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import PIL  # noqa: F401

        pillow = "yes"
    except ImportError:
        pillow = "no"
    try:  # the JAX package's native PNG codec; the port does not need it
        ctypes.CDLL(str(ROOT / "native" / "libimage_codec.so"))
        codec = "loads"
    except OSError:
        codec = "does not load"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"phase 1 environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc '{nvcc}', devices {torch.cuda.device_count()}, "
        f"Pillow {pillow}, native codec {codec}, PNG writer: the port's own (zlib), tf32 off"
    )
    return card


def phase_build():
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    t0 = time.perf_counter()
    ffc.library()
    secs = time.perf_counter() - t0
    usage = [ln.strip() for ln in ffc.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build K1: {secs:.2f} s into {ffc.BUILD_DIR} | " + " | ".join(usage))


def make_case(torch, levels, max_res, feat, hidden, out, n, gen, dev):
    from signerf_tpu_torch.ops import factor_grid as fg

    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [
        [(torch.randn(r, feat, generator=gen) * 0.2).to(dev) for _ in range(3)]
        for r in cfg.resolutions
    ]
    d = cfg.out_dim
    bf = torch.bfloat16
    ws = [
        (torch.randn(d, hidden, generator=gen) * 0.1).to(dev, bf),
        (torch.randn(hidden, generator=gen) * 0.05).to(dev, bf),
        (torch.randn(hidden, out, generator=gen) * 0.1).to(dev, bf),
        (torch.randn(out, generator=gen) * 0.05).to(dev, bf),
    ]
    x = torch.rand(n, 3, generator=gen).to(dev)
    return (cfg.resolutions, feat, fg.pack_tables(lines), *ws, x)


def phase_kernel(torch) -> dict:
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    schedules = [  # name, (levels, max_res, F, H, O), samples per ray in the render
        ("proposal", (5, 128, 8, 16, 1), 256),
        ("prop256", (5, 256, 8, 16, 1), 96),
        ("final", (8, 2048, 16, 64, 16), 48),
    ]
    worst, chunk_ms, chunk_plain_ms = 0.0, 0.0, 0.0
    for name, shape, per_ray in schedules:
        for n in sorted({257, 1 << 21, CHUNK * per_ray}):
            args = make_case(torch, *shape, n, gen, dev)
            x = args[-1]
            if n == 257:
                x[:4] = torch.tensor(
                    [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=dev
                )
            got = ffc.density_mlp_cuda(*args)
            torch.cuda.synchronize()
            want = ffc.density_mlp_plain(*args)
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()), 1e-3)
            if not bool(torch.isfinite(got).all()) or err > KERNEL_TOL * scale:
                fail(f"K1 {name} N={n}: max abs err {err} > {KERNEL_TOL} x {scale}")
            worst = max(worst, err)
            line = f"phase 3 K1 {name} N={n}: max_abs_err {err:.3g} ({err / scale:.3g} of max|ref|)"
            if n > 257:
                iters = 20
                # turns: plain, kernel, kernel, plain (compare within one call)
                p1 = cuda_ms(lambda: ffc.density_mlp_plain(*args), 3)
                k1 = cuda_ms(lambda: ffc.density_mlp_cuda(*args), iters)
                k2 = cuda_ms(lambda: ffc.density_mlp_cuda(*args), iters)
                p2 = cuda_ms(lambda: ffc.density_mlp_plain(*args), 3)
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                line += f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({p_ms / k_ms:.2f}x)"
                if n == CHUNK * per_ray:
                    chunk_ms += k_ms
                    chunk_plain_ms += p_ms
            print(line, flush=True)
            del args, got, want, x
    torch.cuda.empty_cache()
    print(
        f"phase 3 K1 per 8192-ray chunk (its 3 calls): kernel {chunk_ms:.4f} ms, "
        f"plain {chunk_plain_ms:.4f} ms"
    )
    return {"max_abs_err": worst, "ms": chunk_ms, "plain_ms": chunk_plain_ms}


def write_scene(root: Path) -> Path:
    """A synthetic dataset: cameras on a ring, flat gray images, w/h given."""
    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.utils.images import save_array_png

    n, w, h = SCENE["cameras"], SCENE["width"], SCENE["height"]
    (root / "images").mkdir(parents=True)
    poses = circle_poses(n, radius=2.0, theta=70.0, phi=(0.0, 360.0 * (n - 1) / n)).numpy()
    frames = []
    for i in range(n):
        save_array_png(np.full((h, w, 3), 0.5, np.float32), root / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
    meta = {"fl_x": 0.8 * w, "fl_y": 0.8 * w, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def phase_render(torch, card: str) -> int:
    """Returns K1's launch count in the CLI run."""
    import numpy as np

    from signerf_tpu_torch import render as cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.utils.images import to_uint8

    w, h, arc = SCENE["width"], SCENE["height"], SCENE["arc"]
    rays = arc * w * h
    chunks = arc * -(-(w * h) // CHUNK)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        data = write_scene(tmp / "scene")
        out = tmp / "renders"
        argv = ["--data", str(data), "--output", str(out), "--arc", str(arc), "--device", "cuda"]
        torch.cuda.synchronize()
        ffc.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = ffc.launches
        if rc != 0:
            fail(f"render CLI returned {rc}")
        if launches != 3 * chunks:
            fail(f"K1 launched {launches} times in the render, expected 3 x {chunks} chunks")

        # The same model (same seed) rendered directly: warm timing, output checks.
        parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
        dev = torch.device("cuda")
        model = cli.build_model(NerfactoModelConfig(), len(parsed.image_filenames), dev)
        cams = cli.arc_cameras(parsed.cameras.to(dev), arc, 1.0, 70.0)
        aabb = torch.as_tensor(parsed.scene_box_aabb, device=dev)
        frames = list(cli.render_cameras(model, cams, aabb))
        frame_s = []  # warm per-frame render times, host clock after a sync
        for _ in range(RENDER_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _frame in cli.render_cameras(model, cams, aabb):
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        frame_s.sort()
        median_s = frame_s[len(frame_s) // 2]
        for i, f in enumerate(frames):
            for k, v in f.items():
                if not bool(torch.isfinite(v).all()):
                    fail(f"camera {i}: non-finite {k}")
            acc = f["accumulation"]
            if float(acc.min()) < 0.0 or float(acc.max()) > 1.0 + 1e-5:
                fail(f"camera {i}: accumulation outside [0, 1]")
            if tuple(f["rgb"].shape) != (h, w, 3):
                fail(f"camera {i}: rgb shape {tuple(f['rgb'].shape)}")
            png = read_png(out / f"rgb_{i:05d}.png")
            if not np.array_equal(png, to_uint8(f["rgb"].cpu().numpy())):
                fail(f"camera {i}: the CLI's rgb PNG differs from the direct render")
            if not (out / f"depth_{i:05d}.png").exists():
                fail(f"camera {i}: no depth PNG")
        acc_mean = float(torch.stack([f["accumulation"].mean() for f in frames]).mean())
        print(
            f"phase 4 render CLI: {arc} x {w}x{h} = {rays} rays in {chunks} chunks of {CHUNK}, "
            f"K1 launches {launches} (= 3 x {chunks}), CLI wall {cli_s:.3f} s "
            f"({rays / cli_s:.0f} rays/s incl. start-up and PNG writes); warm render, "
            f"median of {len(frame_s)} frames {median_s * 1e3:.3f} ms = {w * h / median_s:.0f} "
            f"rays/s (frames {frame_s[0] * 1e3:.3f} to {frame_s[-1] * 1e3:.3f} ms); "
            f"mean accumulation {acc_mean:.4f}; on {card}",
            flush=True,
        )

        # One chunk with the plain twin in place of the kernel.
        bundle = cams.generate_rays(camera_index=0, aabb=aabb).reshape((h * w,))
        chunk = bundle.map(lambda x: x[:CHUNK])
        render = make_eval_render(model, chunk_size=CHUNK)
        kern = render(chunk)
        launch_kernel = ffc.density_mlp_cuda
        ffc.density_mlp_cuda = ffc.density_mlp_plain
        try:
            plain = render(chunk)
        finally:
            ffc.density_mlp_cuda = launch_kernel
        d_rgb = float((kern["rgb"] - plain["rgb"]).abs().max())
        d_acc = float((kern["accumulation"] - plain["accumulation"]).abs().max())
        print(
            f"phase 4 one chunk, kernel vs plain twin: max |d rgb| {d_rgb:.3g}, "
            f"max |d accumulation| {d_acc:.3g} (tolerance {CHUNK_TOL})"
        )
        if d_rgb > CHUNK_TOL or d_acc > CHUNK_TOL:
            fail("kernel and plain renders of one chunk disagree")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import signerf_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the repository root: {exc}")

    card = phase_environment(torch)
    phase_build()
    k1 = phase_kernel(torch)
    launches = phase_render(torch, card)
    kernels = [
        {
            "name": "fused_factor_density",
            "route": "cuda",
            "source": "signerf_tpu_torch/csrc/fused_factor_density.cu",
            "replaces": "signerf_tpu/ops/fused_factor_pallas.py:1475",
            "launches": launches,
            "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"],
            "plain_ms": k1["plain_ms"],
        }
    ]
    print(json.dumps({"kernels": kernels}))
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
