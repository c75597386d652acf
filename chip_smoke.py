#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (any failure exits non-zero before
the result line):

  1. environment: card name and power limit, torch / CUDA / nvcc versions,
     image libraries present;
  2. build K1 and K2 (signerf_tpu_torch/csrc/fused_factor_density{,_bwd}.cu),
     both nvcc processes at once;
  3. K1 against its plain PyTorch twin on the card, at the three density
     schedules, at N = 2^21 and at the sample counts of one 8192-ray render
     chunk, plus N = 257 with u in {0, 1}: error and CUDA-event times;
  4. K2 (both halves) against its plain twin at the sample counts of one
     4096-ray train step, plus N = 257: per-leaf error and times;
  5. the render CLI at the full width of `signerf_nerfacto` on a synthetic
     512x512 scene (--arc 2 --device cuda, seeded random weights): K1's
     launches must be 3 x chunks; the PNGs must equal a direct render's
     output; outputs finite, accumulation in [0, 1]; rays/s; then one chunk
     again with the plain twin in place of the kernel;
  6. the train CLI (`signerf_nerfacto --train-only True --device cuda`) for
     300 steps at full width on the same scene: finite, falling loss; K1 and
     K2's tables half launched 3 x steps, K2's coords half never; warm
     rays/s, step times, peak memory;
  7. a few steps with camera opt on: K2's coords half 3 x steps;
  8. one step's gradients with both plain twins in place of K1 and K2;
  9. the trained checkpoint through the render and eval CLIs (PSNR);
 10. a JSON line per kernel, then {"ok": true, "device": {...}} last.

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
# K2 vs plain twin, per leaf (line grads, dW0, db0, dW1, db1, coords):
# same contract, f32 sums in another order (atomics): norm-relative.
K2_TOL = 1e-4
# Samples of one 4096-ray train step: (name, schedule, samples per ray).
TRAIN_RAYS = 4096
TRAIN_SCHEDULES = [
    ("proposal", (5, 128, 8, 16, 1), 256),
    ("prop256", (5, 256, 8, 16, 1), 96),
    ("final", (8, 2048, 16, 64, 16), 48),
]
SPHERE_RADIUS = 0.6
# The eval CLI's PSNR after TRAIN_STEPS steps must beat the seeded init's by
# this much. On this scene (81% white background, far plane 1000) both
# packages plateau near MSE 0.066 within 200 steps (a CPU run at 48x48), so
# the gate is the gain, not an absolute PSNR.
EVAL_GAIN_DB = 3.0
TRAIN_STEPS = 300  # short runs miss the density NaNs that 300+ steps show
CAMERA_OPT_STEPS = 4
# One step's gradients, kernels vs plain twins (same params, same pixels,
# deterministic sampling): per-leaf norm-relative. A flipped bf16 rounding
# in the forward moves a resampled bin a little, which moves some grads.
STEP_TOL = 0.05


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
    usage = [
        ln.strip().removeprefix("ptxas info    : ")
        for ln in ffc.build_log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    ]
    print(f"phase 2 build K1 and K2 (two nvcc at once): {secs:.2f} s into {ffc.BUILD_DIR} | " + " | ".join(usage))


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
    """A synthetic, multi-view consistent dataset: cameras on a ring looking
    at a sphere of radius 0.6 shaded by |hit point| / 0.6, on white (the
    analytic scene of examples/fit_synthetic.py)."""
    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.utils.images import save_array_png

    n, w, h = SCENE["cameras"], SCENE["width"], SCENE["height"]
    (root / "images").mkdir(parents=True)
    poses = circle_poses(n, radius=2.0, theta=70.0, phi=(0.0, 360.0 * (n - 1) / n)).numpy()
    f = 0.8 * w
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d_cam = np.stack([(xx - w / 2) / f, -(yy - h / 2) / f, -np.ones_like(xx)], -1)
    frames = []
    for i in range(n):
        d = d_cam @ poses[i, :3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = poses[i, :3, 3]
        b = d @ o
        disc = b * b - (o @ o - SPHERE_RADIUS**2)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit_point = o + d * t[..., None]
        img = np.where((disc > 0)[..., None], np.abs(hit_point) / SPHERE_RADIUS, 1.0)
        save_array_png(img.astype(np.float32), root / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
    meta = {"fl_x": f, "fl_y": f, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def phase_render(torch, card: str, data: Path, tmp: Path) -> int:
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
        f"phase 5 render CLI: {arc} x {w}x{h} = {rays} rays in {chunks} chunks of {CHUNK}, "
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
        f"phase 5 one chunk, kernel vs plain twin: max |d rgb| {d_rgb:.3g}, "
        f"max |d accumulation| {d_acc:.3g} (tolerance {CHUNK_TOL})"
    )
    if d_rgb > CHUNK_TOL or d_acc > CHUNK_TOL:
        fail("kernel and plain renders of one chunk disagree")
    return launches


def rel_err(a, b) -> float:
    """Norm-relative error of a against b."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-12))


def phase_k2(torch) -> dict:
    """K2, both halves, against its plain twin at one train step's shapes."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    worst_rel = worst_abs = 0.0
    step = {"tables": 0.0, "tables_plain": 0.0, "coords": 0.0, "coords_plain": 0.0}
    for name, shape, per_ray in TRAIN_SCHEDULES:
        for n in (257, TRAIN_RAYS * per_ray):
            res, feat, tables, w0, b0, w1, _, x = make_case(torch, *shape, n, gen, dev)
            if n == 257:
                x[:4] = torch.tensor(
                    [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=dev
                )
            g = torch.randn(n, shape[4], generator=gen).to(dev)
            args = (res, feat, tables, w0, b0, w1, x, g)
            got = ffc.density_mlp_bwd_cuda(*args, tables_half=True, coords_half=True)
            torch.cuda.synchronize()
            want = ffc.density_mlp_bwd_plain(*args, tables_half=True, coords_half=True)
            names = ["line grads", "dW0", "db0", "dW1", "db1", "coords"]
            errs = []
            for leaf, a, b in zip(names, [got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
                if not bool(torch.isfinite(a).all()):
                    fail(f"K2 {name} N={n}: non-finite {leaf}")
                r, e = rel_err(a, b), float((a - b).abs().max())
                if r > K2_TOL:
                    fail(f"K2 {name} N={n}: {leaf} norm-relative error {r:.3g} > {K2_TOL}")
                errs.append(r)
                worst_rel, worst_abs = max(worst_rel, r), max(worst_abs, e)
            line = f"phase 4 K2 {name} N={n}: norm-rel err (lines, dW0, db0, dW1, db1, coords) " + " ".join(
                f"{e:.2e}" for e in errs
            )
            if n > 257:
                # turns: plain, kernel, kernel, plain (compare within one call)
                tables = lambda: ffc.density_mlp_bwd_cuda(*args)  # noqa: E731
                tables_plain = lambda: ffc.density_mlp_bwd_plain(*args)  # noqa: E731
                coords = lambda: ffc.density_mlp_bwd_cuda(*args, tables_half=False, coords_half=True)  # noqa: E731
                coords_plain = lambda: ffc.density_mlp_bwd_plain(*args, tables_half=False, coords_half=True)  # noqa: E731
                p1 = cuda_ms(tables_plain, 3)
                k1 = cuda_ms(tables, 20)
                k2 = cuda_ms(tables, 20)
                p2 = cuda_ms(tables_plain, 3)
                c_ms, cp_ms = cuda_ms(coords, 20), cuda_ms(coords_plain, 3)
                t_ms, tp_ms = (k1 + k2) / 2, (p1 + p2) / 2
                step["tables"] += t_ms
                step["tables_plain"] += tp_ms
                step["coords"] += c_ms
                step["coords_plain"] += cp_ms
                line += (
                    f" | tables half: kernel {t_ms:.4f} ms, plain {tp_ms:.4f} ms; "
                    f"coords half: kernel {c_ms:.4f} ms, plain {cp_ms:.4f} ms"
                )
            print(line, flush=True)
            del args, got, want
    torch.cuda.empty_cache()
    print(
        f"phase 4 K2 per {TRAIN_RAYS}-ray train step (its 3 calls): tables half kernel "
        f"{step['tables']:.4f} ms vs plain {step['tables_plain']:.4f} ms; coords half kernel "
        f"{step['coords']:.4f} ms vs plain {step['coords_plain']:.4f} ms; worst norm-rel "
        f"{worst_rel:.3g} (bound {K2_TOL}), worst max abs {worst_abs:.3g}",
        flush=True,
    )
    return {"max_abs_err": worst_abs, **step}


def train_argv(data: Path, out: Path, steps: int, *extra: str):
    return [
        "signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cuda",
        "--max-num-iterations", str(steps), "--steps-per-save", str(steps),
        "--output-dir", str(out), *extra,
    ]


def zero_counts(ffc) -> None:
    ffc.launches = ffc.bwd_table_launches = ffc.bwd_coords_launches = 0


def counts(ffc):
    return ffc.launches, ffc.bwd_table_launches, ffc.bwd_coords_launches


def phase_train(torch, card: str, data: Path, tmp: Path) -> dict:
    """The train CLI at full width; per-step losses and step-end CUDA events
    are recorded through the train step's loss function (no host sync)."""
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    losses, events = [], []
    real_loss = tts.default_loss_fn

    def recording_loss(model, outputs, batch):
        total, ld = real_loss(model, outputs, batch)
        losses.append(total.detach())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return total, ld

    out = tmp / "train"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tts.default_loss_fn = recording_loss
    zero_counts(ffc)
    t0 = time.perf_counter()
    try:
        rc = cli.main(train_argv(data, out, TRAIN_STEPS))
    finally:
        tts.default_loss_fn = real_loss
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2t, k2c = counts(ffc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        fail(f"train CLI returned {rc}")
    if (k1, k2t, k2c) != (3 * TRAIN_STEPS, 3 * TRAIN_STEPS, 0):
        fail(f"train launches K1 {k1}, K2 tables {k2t}, K2 coords {k2c}; expected "
             f"{3 * TRAIN_STEPS}, {3 * TRAIN_STEPS}, 0")
    loss = torch.stack(losses).float().cpu()
    if len(loss) != TRAIN_STEPS or not bool(torch.isfinite(loss).all()):
        fail(f"{len(loss)} losses recorded for {TRAIN_STEPS} steps, finite: {bool(torch.isfinite(loss).all())}")
    first, last = float(loss[:20].mean()), float(loss[-20:].mean())
    if not last < first:
        fail(f"loss did not fall: first 20 steps {first:.5f}, last 20 {last:.5f}")
    step_ms = sorted(events[i - 1].elapsed_time(events[i]) for i in range(11, len(events)))
    median = step_ms[len(step_ms) // 2]
    ckpts = sorted((out / "experiment" / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    if not ckpts or ckpts[-1].name != f"step-{TRAIN_STEPS:09d}.pt":
        fail(f"no step-{TRAIN_STEPS:09d}.pt written: {[c.name for c in ckpts]}")
    print(
        f"phase 6 train CLI: signerf_nerfacto, {TRAIN_STEPS} steps of {TRAIN_RAYS} rays at full width, "
        f"loss {float(loss[0]):.5f} -> {float(loss[-1]):.5f} (mean of first 20 {first:.5f}, last 20 "
        f"{last:.5f}); launches K1 {k1}, K2 tables {k2t}, K2 coords {k2c}; warm step median "
        f"{median:.3f} ms over {len(step_ms)} steps (range {step_ms[0]:.3f} to {step_ms[-1]:.3f} ms) = "
        f"{TRAIN_RAYS / median * 1e3:.0f} train rays/s; CLI wall {wall:.3f} s; peak memory "
        f"{peak:.3f} GiB; on {card}",
        flush=True,
    )
    return {"launches": k2t, "ckpt_dir": ckpts[-1].parent, "rays_per_s": TRAIN_RAYS / median * 1e3}


def phase_camera_opt(torch, data: Path, tmp: Path) -> int:
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    torch.cuda.synchronize()
    zero_counts(ffc)
    rc = cli.main(train_argv(data, tmp / "camopt", CAMERA_OPT_STEPS, "--steps-per-call", "1",
                             "--pipeline.model.use-camera-opt", "True"))
    torch.cuda.synchronize()
    got = counts(ffc)
    want = (3 * CAMERA_OPT_STEPS,) * 3
    if rc != 0 or got != want:
        fail(f"camera-opt train: rc {rc}, launches (K1, K2 tables, K2 coords) {got}, expected {want}")
    print(f"phase 7 train CLI with camera opt, {CAMERA_OPT_STEPS} steps: launches (K1, K2 tables, "
          f"K2 coords) {got}", flush=True)
    return got[2]


def phase_plain_step(torch, data: Path) -> None:
    """One step's gradients, kernels vs both plain twins, same params and pixels."""
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.data.pixel_samplers import sample_pixels
    from signerf_tpu_torch.engine.train_step import default_loss_fn
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    cams = parse_transforms(SIGNeRFDataParserConfig(data=data)).cameras.to(dev)
    model = NerfactoModel(NerfactoModelConfig(), len(cams))
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    idx = sample_pixels(torch.Generator(device=dev).manual_seed(0), TRAIN_RAYS, len(cams), cams.height, cams.width)
    target = torch.rand(TRAIN_RAYS, 3, generator=torch.Generator().manual_seed(0)).to(dev)

    def grads():
        model.zero_grad()
        out = model(cams.generate_rays_at(idx), None, train=True, anneal=1.0)
        total, _ = default_loss_fn(model, out, {"image": target})
        total.backward()
        return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, gk = grads()
    fwd, bwd = ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda
    ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda = ffc.density_mlp_plain, ffc.density_mlp_bwd_plain
    try:
        loss_p, gp = grads()
    finally:
        ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda = fwd, bwd
    errs = {n: rel_err(gk[n], gp[n]) for n in gk}
    worst = max(errs, key=errs.get)
    print(
        f"phase 8 one train step, kernels vs plain twins: loss {loss_k:.6f} vs {loss_p:.6f}; worst "
        f"per-leaf norm-relative grad difference {errs[worst]:.3g} ({worst}), median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g} (bound {STEP_TOL})",
        flush=True,
    )
    if errs[worst] > STEP_TOL or not abs(loss_k - loss_p) <= 1e-3 * abs(loss_p):
        fail("kernel and plain-twin train steps disagree")


def phase_eval(torch, data: Path, tmp: Path, ckpt_dir: Path) -> float:
    """The trained checkpoint: its train-view PSNR (camera 0 rendered as the
    train step casts rays, with its own appearance code), then the render
    and eval CLIs (restore surgery; the eval CLI clips rays to the scene
    box, as the JAX CLI does)."""
    import json as _json

    from signerf_tpu_torch import eval as eval_cli
    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops.image_metrics import psnr as psnr_fn
    from signerf_tpu_torch.utils.images import load_rgb

    dev = torch.device("cuda")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    cams = parsed.cameras.to(dev)
    model = NerfactoModel(NerfactoModelConfig(), len(cams))
    model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
    model = model.to(dev).eval()
    h, w = cams.height, cams.width
    out = make_eval_render(model, chunk_size=CHUNK)(
        cams.generate_rays(camera_index=0).reshape((h * w,)), appearance_mode="index"
    )
    gt = torch.from_numpy(load_rgb(parsed.image_filenames[0])).to(dev).float() / 255.0
    train_view = float(psnr_fn(out["rgb"].reshape(h, w, 3), gt))

    render_out = tmp / "trained_render"
    if render_cli.main(["--data", str(data), "--output", str(render_out), "--load-dir", str(ckpt_dir),
                        "--arc", "1", "--device", "cuda", "--depth", "false"]) != 0:
        fail("render CLI could not render the trained checkpoint")
    if not (render_out / "rgb_00000.png").exists():
        fail("render CLI wrote no PNG for the trained checkpoint")
    psnr = {}
    for name, load in [("trained", ["--load-dir", str(ckpt_dir)]), ("init", [])]:
        path = tmp / f"eval_{name}.json"
        if eval_cli.main(["--data", str(data), "--output", str(path), "--device", "cuda", *load]) != 0:
            fail(f"eval CLI failed ({name})")
        psnr[name] = _json.loads(path.read_text())["psnr"]
    print(f"phase 9 trained checkpoint: train-view PSNR (camera 0) {train_view:.3f} dB; render CLI "
          f"wrote it; eval CLI PSNR over {SCENE['cameras']} cameras {psnr['trained']:.3f} dB (seeded "
          f"init {psnr['init']:.3f} dB, gain required {EVAL_GAIN_DB} dB)", flush=True)
    if not psnr["trained"] >= psnr["init"] + EVAL_GAIN_DB or train_view != train_view:
        fail("training did not raise the eval CLI's PSNR enough, or the train view is NaN")
    return psnr["trained"]


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
    k2 = phase_k2(torch)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        data = write_scene(tmp / "scene")
        render_launches = phase_render(torch, card, data, tmp)
        train = phase_train(torch, card, data, tmp)
        coords_launches = phase_camera_opt(torch, data, tmp)
        phase_plain_step(torch, data)
        phase_eval(torch, data, tmp, train["ckpt_dir"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    replaces = "signerf_tpu/ops/fused_factor_pallas.py"
    kernels = [
        {
            "name": "fused_factor_density",
            "route": "cuda",
            "source": "signerf_tpu_torch/csrc/fused_factor_density.cu",
            "replaces": f"{replaces}:1475",
            "launches": render_launches,
            "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"],
            "plain_ms": k1["plain_ms"],
        },
        {
            "name": "fused_factor_density_bwd (tables and MLP half)",
            "route": "cuda",
            "source": "signerf_tpu_torch/csrc/fused_factor_density_bwd.cu",
            "replaces": f"{replaces}:1686",
            "launches": train["launches"],
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["tables"],
            "plain_ms": k2["tables_plain"],
        },
        {
            "name": "fused_factor_density_bwd (coords half)",
            "route": "cuda",
            "source": "signerf_tpu_torch/csrc/fused_factor_density_bwd.cu",
            "replaces": f"{replaces}:1776",
            "launches": coords_launches,
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["coords"],
            "plain_ms": k2["coords_plain"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
