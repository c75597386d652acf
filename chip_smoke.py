#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (any failure exits non-zero before
the result line):

  1. environment: card name and power limit, torch / CUDA / nvcc versions,
     image libraries present;
  2. build K1 to K6 (signerf_tpu_torch/csrc/fused_factor_{density,
     density_bwd,encode,grad_dot}.cu), all four nvcc processes at once, with
     ptxas's registers, shared memory and spills per kernel;
  3. K1 against its plain PyTorch twin on the card, at the three density
     schedules, at N = 2^21 and at the sample counts of one 8192-ray render
     chunk, plus N = 257 with u in {0, 1}: error and CUDA-event times;
  4. K2 (both halves) against its plain twin at the sample counts of one
     4096-ray train step, plus N = 257: per-leaf error and times;
  5. K3, K4 (both halves), K5 and K6 (both halves) against their plain twins
     at one `signerf` micro-batch's base-field shapes (N = 196,608, uniform
     and clustered coordinates) and at N = 257 with u in {0, 1}: error and
     CUDA-event times;
  6. the render CLI at the full width of `signerf_nerfacto` on a synthetic
     512x512 scene (--arc 2 --device cuda, seeded random weights): K1's
     launches must be 3 x chunks; the PNGs must equal a direct render's
     output; outputs finite, accumulation in [0, 1]; rays/s; then one chunk
     again with the plain twin in place of the kernel;
  7. the train CLI (`signerf_nerfacto --train-only True --device cuda`) for
     300 steps at full width on the same scene: finite, falling loss; K1 and
     K2's tables half launched 3 x steps, K2's coords half never; warm
     rays/s, step times, peak memory;
  8. a few steps with camera opt on: K2's coords half 3 x steps;
  9. one step's gradients with both plain twins in place of K1 and K2;
 10. the trained checkpoint through the render and eval CLIs (PSNR);
 11. the train CLI for `signerf --train-only True --device cuda` at full
     width (16,384 rays as 16 patches of 32x32, 4 micro-batches, L1 + LPIPS
     with random alex weights and the uncalibrated warning, normals and
     both normals losses): finite, falling loss; K3, K5 and the tables
     halves of K4 and K6 launched 4 x steps, K1 and K2's tables half
     8 x steps, no coords half; warm rays/s, step times, peak memory;
 12. two `signerf` steps with camera opt on: the coords halves of K2, K4
     and K6 launch;
 13. one `signerf` micro-batch's gradients with all six plain twins in place
     of the kernels; finite normals; the orientation loss alone reaches the
     line tables; a profile of warm train steps (device time per kernel);
 14. one full-frame eval render of the trained `signerf` model through
     `make_eval_render`: K3 = K5 = chunks, K1 = 2 x chunks, outputs finite;
 15. a JSON line per kernel, then {"ok": true, "device": {...}} last.

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
# The `signerf` method: 16,384 rays a step as 32x32 patches, 4 micro-batches
# of 4096 rays x 48 base-field samples.
SIGNERF_RAYS = 16384
SIGNERF_MICRO = 4
SIGNERF_SAMPLES = SIGNERF_RAYS // SIGNERF_MICRO * 48
SIGNERF_STEPS = 300
SIGNERF_CAMERA_OPT_STEPS = 2
BASE_SCHEDULE = (8, 2048, 16)  # levels, max_res, F of the base field
# K3 to K6 vs their plain twins: the same f32 formulas on the same bf16
# tables; FMA contraction and summation order move the last bits only.
# K3, max abs error over max|ref|: a product of three lerps differs by a few
# ulps (~1e-6). K4, K5, K6, norm-relative per leaf: f32 sums in another
# order, and atomics in the tables halves, as K2 (K2_TOL).
K3_TOL = 1e-5
K456_TOL = 1e-4
PROFILE_STEPS = 3


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
    print(f"phase 2 build K1 to K6 ({len(ffc.SOURCES)} nvcc at once): {secs:.2f} s into {ffc.BUILD_DIR} | "
          + " | ".join(usage))


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


def encode_case(torch, n, gen, dev, clustered=False):
    """Base-field tables, coordinates, g [N, 128] and ct [N, 3] on the card.
    Clustered coordinates are points along rays from a ring of cameras at
    radius 2 through the scene's centre, as the train step samples them;
    N = 257 starts with rows on u = 0 and u = 1."""
    from signerf_tpu_torch.ops import factor_grid as fg
    from signerf_tpu_torch.ops.contraction import contract_to_unit

    levels, max_res, feat = BASE_SCHEDULE
    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [[torch.randn(r, feat, generator=gen) * 0.2 for _ in range(3)] for r in cfg.resolutions]
    if clustered:
        rays = n // 48
        phi = torch.rand(rays, generator=gen) * 6.2832
        origin = torch.stack([2 * torch.cos(phi), 2 * torch.sin(phi), 0.7 * torch.ones(rays)], -1)
        target = torch.randn(rays, 3, generator=gen) * 0.3
        d = torch.nn.functional.normalize(target - origin, dim=-1)
        t = 1.0 + 2.0 * torch.rand(rays, 48, generator=gen).sort(-1).values
        x = contract_to_unit(origin[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    else:
        x = torch.rand(n, 3, generator=gen)
    if n == 257:
        x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]])
    g = torch.randn(n, cfg.out_dim, generator=gen)
    ct = torch.randn(n, 3, generator=gen)
    return (cfg.resolutions, feat, fg.pack_tables(lines).to(dev), x.to(dev)), g.to(dev), ct.to(dev)


def twin_ms(torch, kernel, plain, iters: int = 20):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_k3_k6(torch) -> dict:
    """K3 to K6 against their plain twins at one signerf micro-batch's
    base-field shapes and at N = 257."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    names = ["K3", "K4 tables", "K4 coords", "K5", "K6 tables", "K6 coords"]
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in names}
    for label, n, clustered in [("uniform", SIGNERF_SAMPLES, False), ("clustered", SIGNERF_SAMPLES, True),
                                ("boundary", 257, False)]:
        args, g, ct = encode_case(torch, n, gen, dev, clustered)
        calls = {
            "K3": (lambda f: f(*args), ffc.encode_cuda, ffc.encode_plain),
            "K4": (lambda f: f(*args, g, True, True), ffc.encode_bwd_cuda, ffc.encode_bwd_plain),
            "K5": (lambda f: f(*args, g), ffc.grad_dot_cuda, ffc.grad_dot_plain),
            "K6": (lambda f: f(*args, g, ct, True, True), ffc.grad_dot_bwd_cuda, ffc.grad_dot_bwd_plain),
        }
        line = [f"phase 5 {label} N={n}:"]
        for k, (call, kern, plain) in calls.items():
            got = call(kern)
            torch.cuda.synchronize()
            want = call(plain)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            leaves = {"K4": ["K4 tables", "K4 coords"], "K6": ["K6 tables", "grad_g", "K6 coords"]}.get(k, [k])
            errs = []
            for leaf, a, b in zip(leaves, got, want):
                if not bool(torch.isfinite(a).all()):
                    fail(f"{leaf} {label} N={n}: non-finite output")
                if k == "K3":
                    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                    bound = K3_TOL
                else:
                    err, bound = rel_err(a, b), K456_TOL
                if err > bound:
                    fail(f"{leaf} {label} N={n}: error {err:.3g} > {bound}")
                errs.append(f"{leaf} {err:.2e}")
                entry = result.get(leaf, result.get("K6 tables"))
                entry["max_abs_err"] = max(entry["max_abs_err"], float((a - b).abs().max()))
            line.append(", ".join(errs))
        print(" ".join(line), flush=True)
        if n == 257:
            continue
        times = {
            "K3": (lambda: ffc.encode_cuda(*args), lambda: ffc.encode_plain(*args)),
            "K4 tables": (lambda: ffc.encode_bwd_cuda(*args, g), lambda: ffc.encode_bwd_plain(*args, g)),
            "K4 coords": (lambda: ffc.encode_bwd_cuda(*args, g, False, True),
                          lambda: ffc.encode_bwd_plain(*args, g, False, True)),
            "K5": (lambda: ffc.grad_dot_cuda(*args, g), lambda: ffc.grad_dot_plain(*args, g)),
            "K6 tables": (lambda: ffc.grad_dot_bwd_cuda(*args, g, ct), lambda: ffc.grad_dot_bwd_plain(*args, g, ct)),
            "K6 coords": (lambda: ffc.grad_dot_bwd_cuda(*args, g, ct, False, True),
                          lambda: ffc.grad_dot_bwd_plain(*args, g, ct, False, True)),
        }
        line = [f"phase 5 {label} N={n} times (kernel vs plain, ms):"]
        for k, (kern, plain) in times.items():
            k_ms, p_ms = twin_ms(torch, kern, plain)
            if label == "uniform":
                result[k]["ms"], result[k]["plain_ms"] = k_ms, p_ms
            line.append(f"{k} {k_ms:.4f} vs {p_ms:.4f} ({p_ms / k_ms:.2f}x);")
        print(" ".join(line), flush=True)
        del args, g, ct
    torch.cuda.empty_cache()
    per_step = sum(result[k]["ms"] for k in ("K3", "K4 tables", "K5", "K6 tables")) * SIGNERF_MICRO
    print(f"phase 5 K3 + K4 tables + K5 + K6 tables per {SIGNERF_RAYS}-ray signerf step "
          f"({SIGNERF_MICRO} micro-batches, uniform coordinates): {per_step:.4f} ms", flush=True)
    return result


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
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = ffc.launches
    if sum(counts(ffc).values()) != launches:
        fail(f"the render CLI launched other kernels than K1: {counts(ffc)}")
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
        f"phase 6 render CLI: {arc} x {w}x{h} = {rays} rays in {chunks} chunks of {CHUNK}, "
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
        f"phase 6 one chunk, kernel vs plain twin: max |d rgb| {d_rgb:.3g}, "
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


def train_argv(method: str, data: Path, out: Path, steps: int, *extra: str):
    return [
        method, "--data", str(data), "--train-only", "True", "--device", "cuda",
        "--max-num-iterations", str(steps), "--steps-per-save", str(steps),
        "--output-dir", str(out), *extra,
    ]


# ffc's launch counters (fused_factor_cuda.COUNTERS order), as the JSON
# line and the printed lines name them.
KERNEL_NAMES = ("K1", "K2 tables", "K2 coords", "K3", "K4 tables", "K4 coords", "K5", "K6 tables", "K6 coords")


def zero_counts(ffc) -> None:
    for name in ffc.COUNTERS:
        setattr(ffc, name, 0)


def counts(ffc) -> dict:
    return {k: getattr(ffc, name) for k, name in zip(KERNEL_NAMES, ffc.COUNTERS)}


def expect_counts(**per_step):
    """The launch counts a run must show, every kernel not named at 0."""
    return lambda steps: {k: per_step.get(k.replace(" ", "_"), 0) * steps for k in KERNEL_NAMES}


NERFACTO_COUNTS = expect_counts(K1=3, K2_tables=3)
SIGNERF_COUNTS = expect_counts(K1=8, K2_tables=8, K3=4, K4_tables=4, K5=4, K6_tables=4)


def phase_train(torch, card: str, data: Path, tmp: Path, method: str, steps: int, rays: int,
                micro: int, expected, phase: int) -> dict:
    """The train CLI at full width; per-micro-batch losses and CUDA events
    are recorded through the train step's loss function (no host sync)."""
    import warnings

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

    out = tmp / method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tts.default_loss_fn = recording_loss
    zero_counts(ffc)
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc = cli.main(train_argv(method, data, out, steps))
    finally:
        tts.default_loss_fn = real_loss
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(ffc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        fail(f"{method} train CLI returned {rc}")
    if got != expected(steps):
        fail(f"{method} train launches {got}; expected {expected(steps)}")
    uncalibrated = any("RANDOM-INIT" in str(w.message) for w in caught)
    if method == "signerf" and not uncalibrated:
        fail("the signerf train CLI ran random LPIPS weights without the uncalibrated warning")
    loss = torch.stack(losses).float().cpu()
    if len(loss) != steps * micro or not bool(torch.isfinite(loss).all()):
        fail(f"{len(loss)} losses recorded for {steps} x {micro} micro-batches, finite: "
             f"{bool(torch.isfinite(loss).all())}")
    loss = loss.view(steps, micro).mean(1)
    first, last = float(loss[:20].mean()), float(loss[-20:].mean())
    if not last < first:
        fail(f"{method}: loss did not fall: first 20 steps {first:.5f}, last 20 {last:.5f}")
    ends = events[micro - 1 :: micro]  # each step's last micro-batch loss
    step_ms = sorted(ends[i - 1].elapsed_time(ends[i]) for i in range(11, len(ends)))
    median = step_ms[len(step_ms) // 2]
    ckpts = sorted((out / "experiment" / method / "checkpoints").glob("step-*.pt"))
    if not ckpts or ckpts[-1].name != f"step-{steps:09d}.pt":
        fail(f"no step-{steps:09d}.pt written: {[c.name for c in ckpts]}")
    launched = ", ".join(f"{k} {v}" for k, v in got.items() if v)
    print(
        f"phase {phase} train CLI: {method}, {steps} steps of {rays} rays ({micro} micro-batches) at "
        f"full width, loss {float(loss[0]):.5f} -> {float(loss[-1]):.5f} (mean of first 20 {first:.5f}, "
        f"last 20 {last:.5f}); launches {launched}, all others 0; uncalibrated-LPIPS warning "
        f"{'printed' if uncalibrated else 'none'}; warm step median {median:.3f} ms over {len(step_ms)} "
        f"steps (range {step_ms[0]:.3f} to {step_ms[-1]:.3f} ms) = {rays / median * 1e3:.0f} train rays/s; "
        f"CLI wall {wall:.3f} s; peak memory {peak:.3f} GiB; on {card}",
        flush=True,
    )
    return {"launches": got, "ckpt_dir": ckpts[-1].parent, "rays_per_s": rays / median * 1e3}


def phase_camera_opt(torch, data: Path, tmp: Path, method: str, steps: int, expected, phase: int) -> dict:
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    torch.cuda.synchronize()
    zero_counts(ffc)
    rc = cli.main(train_argv(method, data, tmp / f"{method}_camopt", steps, "--steps-per-call", "1",
                             "--pipeline.model.use-camera-opt", "True"))
    torch.cuda.synchronize()
    got = counts(ffc)
    if rc != 0 or got != expected(steps):
        fail(f"{method} camera-opt train: rc {rc}, launches {got}, expected {expected(steps)}")
    launched = ", ".join(f"{k} {v}" for k, v in got.items() if v)
    print(f"phase {phase} train CLI ({method}) with camera opt, {steps} steps: launches {launched}",
          flush=True)
    return got


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
        f"phase 9 one train step, kernels vs plain twins: loss {loss_k:.6f} vs {loss_p:.6f}; worst "
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
    print(f"phase 10 trained checkpoint: train-view PSNR (camera 0) {train_view:.3f} dB; render CLI "
          f"wrote it; eval CLI PSNR over {SCENE['cameras']} cameras {psnr['trained']:.3f} dB (seeded "
          f"init {psnr['init']:.3f} dB, gain required {EVAL_GAIN_DB} dB)", flush=True)
    if not psnr["trained"] >= psnr["init"] + EVAL_GAIN_DB or train_view != train_view:
        fail("training did not raise the eval CLI's PSNR enough, or the train view is NaN")
    return psnr["trained"]


SIX = ("density_mlp", "density_mlp_bwd", "encode", "encode_bwd", "grad_dot", "grad_dot_bwd")


def signerf_setup(torch, data: Path, ckpt_dir: Path, use_lpips: bool = True):
    """The `signerf` method's datamanager and its trained model on the card."""
    import dataclasses

    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.models.signerf import SIGNeRFModel

    dev = torch.device("cuda")
    pipe = signerf_method().pipeline
    dm = SIGNeRFDataManager(dataclasses.replace(pipe.datamanager, dataparser=dataclasses.replace(
        pipe.datamanager.dataparser, data=data)), dev)
    model = SIGNeRFModel(dataclasses.replace(pipe.model, use_lpips=use_lpips), dm.num_images)
    model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
    return dm, model.to(dev)


def phase_signerf_step(torch, data: Path, ckpt_dir: Path) -> None:
    """One signerf micro-batch (4 patches of 32x32) of the trained model:
    gradients with the six kernels vs the six plain twins, finite normals,
    and the orientation loss's own gradient in the line tables."""
    from signerf_tpu_torch.data.pixel_samplers import gather_pixels
    from signerf_tpu_torch.engine.train_step import default_loss_fn
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    dm, model = signerf_setup(torch, data, ckpt_dir)
    cams = dm.cameras
    rays = SIGNERF_RAYS // SIGNERF_MICRO
    # Four 32x32 patches on the sphere (its image is ~260 px across) and
    # across its silhouette, not on the white background.
    corners = torch.tensor([[0, 240, 240], [1, 240, 112], [2, 112, 240], [3, 360, 360]])
    dy, dx = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    offsets = torch.stack([torch.zeros_like(dy), dy, dx], -1).view(1, -1, 3)
    idx = (corners[:, None] + offsets).view(-1, 3).int().to(dev)
    rb = cams.generate_rays_at(idx)
    batch = {"image": gather_pixels(dm.images, idx).float() / 255.0}

    def grads():
        model.zero_grad()
        out = model(rb, None, train=True, anneal=1.0)
        total, _ = default_loss_fn(model, out, batch)
        total.backward()
        g = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
        return float(total.detach()), g, out

    loss_k, gk, out = grads()
    for key in ("normals_samples", "pred_normals_samples", "normals", "pred_normals"):
        if not bool(torch.isfinite(out[key]).all()):
            fail(f"signerf step: non-finite {key}")
    kernels = {name: getattr(ffc, f"{name}_cuda") for name in SIX}
    for name in SIX:
        setattr(ffc, f"{name}_cuda", getattr(ffc, f"{name}_plain"))
    try:
        loss_p, gp, _ = grads()
    finally:
        for name, fn in kernels.items():
            setattr(ffc, f"{name}_cuda", fn)
    errs = {n: rel_err(gk[n], gp[n]) for n in gk}
    worst = max(errs, key=errs.get)

    model.zero_grad()
    out = model(rb, None, train=True, anneal=1.0)
    model.normals_losses(out)["orientation_loss"].backward()
    line_grads = [p.grad for n, p in model.field.encoding.named_parameters()]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in line_grads):
        fail("signerf step: the orientation loss gives missing or non-finite line-table gradients")
    orient_norm = float(torch.stack([g.norm() for g in line_grads]).norm())
    print(
        f"phase 13 one signerf micro-batch ({rays} rays), six kernels vs six plain twins: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; worst per-leaf norm-relative grad difference {errs[worst]:.3g} "
        f"({worst}), median {sorted(errs.values())[len(errs) // 2]:.3g} (bound {STEP_TOL}); normals "
        f"finite; orientation-loss gradient in the line tables, norm {orient_norm:.4g}",
        flush=True,
    )
    if errs[worst] > STEP_TOL or not abs(loss_k - loss_p) <= 1e-3 * abs(loss_p):
        fail("kernel and plain-twin signerf steps disagree")
    if not orient_norm > 0:
        fail("the orientation loss does not reach the line tables")


# Device kernels by name, for the step profile.
PROFILE_GROUPS = [
    ("K1", ("density_kernel",)),
    ("K2", ("density_bwd_kernel",)),
    ("K3", ("encode_kernel",)),
    ("K4", ("encode_bwd_kernel",)),
    ("K5", ("grad_dot_kernel",)),
    ("K6", ("grad_dot_bwd_kernel",)),
    ("LPIPS convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit_gemm", "winograd", "fft")),
]


def phase_profile(torch, card: str, data: Path, ckpt_dir: Path) -> None:
    """Warm signerf train steps under torch.profiler: device time per step by
    kernel, the device's busy share of the steps' span, and LPIPS (forward
    and backward over one step's 16 patches) timed alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from signerf_tpu_torch.engine.optimizers import make_optimizer
    from signerf_tpu_torch.engine.train_step import make_train_step
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.ops.lpips import lpips

    dev = torch.device("cuda")
    dm, model = signerf_setup(torch, data, ckpt_dir)
    step = make_train_step(model, make_optimizer(signerf_method().optimizers, model), dm.cameras,
                           dm.sampler_settings())
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(2):
        step(i, dm.images, dm.mask_indices, gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(PROFILE_STEPS):
            step(2 + i, dm.images, dm.mask_indices, gen)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / PROFILE_STEPS
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    other = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / PROFILE_STEPS
        name = e.name.lower()
        for group, keys in PROFILE_GROUPS:
            if any(k in name for k in keys):
                groups[group] += ms
                break
        else:
            other += ms
    busy = sum(groups.values()) + other
    if not busy > 0:
        fail("the profiler saw no device time in the signerf steps")
    x = (torch.rand(16, 32, 32, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1).to(dev)
    y = (torch.rand(16, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1).to(dev)

    def lpips_step():
        xx = x.clone().requires_grad_(True)
        lpips(model.lpips_params, xx, y).mean().backward()

    lpips_ms = cuda_ms(lpips_step, 10)
    parts = "; ".join(f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in groups.items())
    print(
        f"phase 13 profile, {PROFILE_STEPS} warm signerf steps of {SIGNERF_RAYS} rays: span "
        f"{span_ms:.3f} ms a step, device busy {busy:.3f} ms ({busy / span_ms:.1%}, idle "
        f"{1 - busy / span_ms:.1%}); {parts}; other kernels {other:.3f} ms ({other / busy:.1%}); "
        f"LPIPS forward + backward over 16 patches alone {lpips_ms:.3f} ms; on {card}",
        flush=True,
    )


def phase_signerf_eval(torch, data: Path, ckpt_dir: Path) -> dict:
    """One full-frame render of the trained signerf model (normals on) through
    make_eval_render: K3 and K5 once per chunk, K1 twice."""
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dm, model = signerf_setup(torch, data, ckpt_dir, use_lpips=False)
    cams = dm.cameras
    h, w = cams.height, cams.width
    chunks = -(-(h * w) // CHUNK)
    bundle = cams.generate_rays(camera_index=0).reshape((h * w,))
    render = make_eval_render(model.eval(), chunk_size=CHUNK)
    torch.cuda.synchronize()
    zero_counts(ffc)
    t0 = time.perf_counter()
    out = render(bundle, appearance_mode="index")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts(ffc)
    want = expect_counts(K1=2, K3=1, K5=1)(chunks)
    if got != want:
        fail(f"signerf eval render launches {got}, expected {want}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"signerf eval render: non-finite {k}")
    acc = out["accumulation"]
    print(f"phase 14 signerf eval render, {w}x{h} in {chunks} chunks of {CHUNK}: launches K1 {got['K1']}, "
          f"K3 {got['K3']}, K5 {got['K5']}, all others 0; outputs finite, accumulation "
          f"{float(acc.min()):.4f} to {float(acc.max()):.4f}; {secs:.3f} s ({h * w / secs:.0f} rays/s, "
          f"the first frame)", flush=True)
    return got


def kernel_entry(name, source, line, launches, stats, ms_key="ms", plain_key="plain_ms"):
    return {
        "name": name,
        "route": "cuda",
        "source": f"signerf_tpu_torch/csrc/{source}",
        "replaces": f"signerf_tpu/ops/fused_factor_pallas.py:{line}",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": stats[ms_key],
        "plain_ms": stats[plain_key],
    }


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
    k36 = phase_k3_k6(torch)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        data = write_scene(tmp / "scene")
        render_launches = phase_render(torch, card, data, tmp)
        train = phase_train(torch, card, data, tmp, "signerf_nerfacto", TRAIN_STEPS, TRAIN_RAYS, 1,
                            NERFACTO_COUNTS, 7)
        camopt = phase_camera_opt(torch, data, tmp, "signerf_nerfacto", CAMERA_OPT_STEPS,
                                  expect_counts(K1=3, K2_tables=3, K2_coords=3), 8)
        phase_plain_step(torch, data)
        phase_eval(torch, data, tmp, train["ckpt_dir"])
        signerf = phase_train(torch, card, data, tmp, "signerf", SIGNERF_STEPS, SIGNERF_RAYS, SIGNERF_MICRO,
                              SIGNERF_COUNTS, 11)
        signerf_camopt = phase_camera_opt(
            torch, data, tmp, "signerf", SIGNERF_CAMERA_OPT_STEPS,
            expect_counts(K1=8, K2_tables=8, K2_coords=8, K3=4, K4_tables=4, K4_coords=4, K5=4,
                          K6_tables=4, K6_coords=4), 12,
        )
        phase_signerf_step(torch, data, signerf["ckpt_dir"])
        phase_profile(torch, card, data, signerf["ckpt_dir"])
        phase_signerf_eval(torch, data, signerf["ckpt_dir"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = signerf["launches"]
    kernels = [
        kernel_entry("fused_factor_density", "fused_factor_density.cu", 1475, render_launches, k1),
        kernel_entry("fused_factor_density_bwd (tables and MLP half)", "fused_factor_density_bwd.cu", 1686,
                     train["launches"]["K2 tables"], k2, "tables", "tables_plain"),
        kernel_entry("fused_factor_density_bwd (coords half)", "fused_factor_density_bwd.cu", 1776,
                     camopt["K2 coords"], k2, "coords", "coords_plain"),
        kernel_entry("fused_factor_encode", "fused_factor_encode.cu", 196, launched["K3"], k36["K3"]),
        kernel_entry("fused_factor_encode_bwd (tables half)", "fused_factor_encode.cu", 626,
                     launched["K4 tables"], k36["K4 tables"]),
        kernel_entry("fused_factor_encode_bwd (coords half)", "fused_factor_encode.cu", 640,
                     signerf_camopt["K4 coords"], k36["K4 coords"]),
        kernel_entry("fused_factor_grad_dot", "fused_factor_grad_dot.cu", 1037, launched["K5"], k36["K5"]),
        kernel_entry("fused_factor_grad_dot_bwd (tables half and grad_g)", "fused_factor_grad_dot.cu", 1315,
                     launched["K6 tables"], k36["K6 tables"]),
        kernel_entry("fused_factor_grad_dot_bwd (coords half)", "fused_factor_grad_dot.cu", 1329,
                     signerf_camopt["K6 coords"], k36["K6 coords"]),
    ]
    print(json.dumps({"kernels": kernels}))
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
