"""Render traffic: a closed loop of one client asking for frames.

Set-up fills the program's model with seeded weights and renders one
frame, which warms every shape (all frames have the same shapes). The
window asks for frame after frame, each pose the next on an arc through
the scene, through the render CLI's path (`render.render_cameras`: the
frame's rays clipped to the scene box, `engine.train_step.make_eval_render`
over chunks of 8192 rays), and waits for each frame before it asks for the
next. After the window, the frames drawn from the seed among the window's
first `check_within` are rendered again by the plain reference, and the
run compares their colours (`rgb_rmse`, the widest of the frames' root mean
square differences over their pixels) and opacities (`acc_rmse`).

End-to-end: `render_rays_per_s`, every frame's rays over the whole window;
`frame_p95_ms`, the 95th percentile of every frame's time; `setup_s`.
"""

from __future__ import annotations

import math
import random
import sys
import time
import types
from typing import Dict

import torch

from drivers import nerf_common as common
from harness import flops, manifest, peaks, scene as scene_lib, trace
from harness.report import LayerContext, Outcome
from harness.stats import percentile
from reference import nerf
from reference import train as ref_train


def arc(tr: Dict, seed: int, device):
    """The window's poses: a fixed arc of `arc_poses` around the scene, the
    same set for every seed; square frames of `frame_size` px at the scene's
    focal. The seed picks the pose the window starts from."""
    size = tr["frame_size"]
    poses = scene_lib.ring_poses(tr["arc_poses"], tr["arc_theta_deg"], device)
    return poses, scene_lib.FOCAL_PER_PX * size, size, int(seed) % tr["arc_poses"]


def build(cell: manifest.Cell, tr: Dict, model_cfg: Dict, seed: int, device) -> types.SimpleNamespace:
    from signerf_tpu_torch.render import render_cameras

    shapes, w0, _ = common.seeded_weights(model_cfg, tr["views"], seed, device)
    model = common.program_model(model_cfg, tr["views"]).to(device).eval()
    common.load_into_program(model, shapes, w0, None)
    poses, focal, size, start = arc(tr, seed, device)
    cams = common.program_cameras(common.Scene(poses, focal, torch.empty((len(poses), size, size, 3),
                                                                         device=device)))
    lo, hi = cell.config["eval"]["scene_box"]
    aabb = torch.tensor([[lo] * 3, [hi] * 3], device=device)

    singles = [cams.slice(slice(k, k + 1)) for k in range(len(poses))]

    def frame(i: int):
        """The window's i-th frame: pose (start + i) of the arc."""
        (out,) = list(render_cameras(model, singles[(start + i) % len(poses)], aabb, chunk_size=tr["chunk_size"]))
        return out["rgb"], out["accumulation"]

    return types.SimpleNamespace(model=model, w0=w0, poses=poses, focal=focal, size=size, start=start, frame=frame)


def reference_frame(model_cfg: Dict, cfg: Dict, tr: Dict, w0, poses, focal, size, pose: int, prec):
    """The reference's render of arc pose `pose`: (rgb, accumulation)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    o, d = scene_lib.pixel_rays(poses[pose % len(poses)], focal, size, size)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    lo, hi = cfg["eval"]["scene_box"]
    near, far = nerf.aabb_near_far(o, d, lo, hi)
    out = ref_train.render_rays(w0, model_cfg, o, d, near, far, prec, tr["reference_block_rays"])
    return out["rgb"].reshape(size, size, 3), out["accumulation"].reshape(size, size, 1)


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b.float()) ** 2).mean().sqrt())


def compare(pairs) -> Dict[str, float]:
    """pairs: [((rgb, acc) of one side, (rgb, acc) of the other)]."""
    return {"rgb_rmse": max(rmse(p[0], r[0]) for p, r in pairs),
            "acc_rmse": max(rmse(p[1], r[1]) for p, r in pairs)}


def run(cell: manifest.Cell, args, t0: float, hooks) -> Outcome:
    tr = common.traffic(cell, hooks)
    model_cfg = common.model_section(cell, hooks)
    device = common.device_of(hooks)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    p = build(cell, tr, model_cfg, args.seed, device)
    p.frame(0)  # every frame has one frame's shapes
    sync()
    setup_s = time.perf_counter() - t0

    # The frames checked are drawn from the seed among the first
    # `check_within` of the window; only theirs are kept.
    check_at = set(random.Random(int(args.seed)).sample(range(tr["check_within"]), tr["check_frames"]))
    kept, times = [], []
    layer_trace = None
    unit_wall = float("nan")
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = p.frame(i)
        sync()
        now = time.perf_counter()
        times.append(now - t)
        if i in check_at:
            kept.append((i, out))
        i += 1
        if args.trace and layer_trace is None and now - t_start >= min(tr["trace_after_s"], args.seconds):
            unit_wall, base = (now - t_start) / len(times), i

            def traced(k, base=base):
                out = p.frame(base + k)
                if base + k in check_at:  # a profiled frame the seed drew is checked too
                    kept.append((base + k, out))

            layer_trace = trace.profile(torch, traced, tr["trace_frames"])
            i += tr["trace_frames"]
            continue
        if now - t_start >= args.seconds:
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    rays_per_frame = p.size * p.size
    t_ref = time.perf_counter()
    pairs = [(out, reference_frame(model_cfg, cell.config, tr, p.w0, p.poses, p.focal, p.size, p.start + k,
                                   nerf.FULL)) for k, out in kept]
    print(f"reference: {len(pairs)} frames in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr, flush=True)
    readings = compare(pairs)
    if hooks is not None and getattr(hooks, "readings", None) is not None:
        hooks.readings.update(readings)
    lim = common.limits(cell, hooks)
    checks = [(name, value, lim[name]) for name, value in readings.items()]

    layer = None
    if args.trace:
        per_ray = flops.nerfacto_per_ray(model_cfg)
        layer = LayerContext(cell=cell.name, config=cell.config, traffic=tr, trace=layer_trace, unit_wall_s=unit_wall,
                             memory_peak_bytes=peak, extra={
                                 "peak_s_per_unit": per_ray.seconds_at_peak(rays_per_frame, False,
                                                                            peaks.BF16_FLOP_PER_S, peaks.F32_FLOP_PER_S),
                                 "factor_bound_ms_per_unit": render_factor_bound_ms(model_cfg, rays_per_frame,
                                                                                    tr["chunk_size"])})
    e2e = {"render_rays_per_s": len(times) * rays_per_frame / window_s,
           "frame_p95_ms": 1e3 * percentile(times, 95.0), "setup_s": setup_s}
    return Outcome(end_to_end=e2e, checks=checks, attempted=len(times), failed=0, memory_peak_bytes=peak,
                   device_kind=kind, device_count=1, layer=layer)


def render_factor_bound_ms(model: Dict, rays: int, chunk: int) -> float:
    """The least ms of a frame's factor-grid work: each field's fused
    density forward over the frame's rays, padded to whole chunks."""
    rays = math.ceil(rays / chunk) * chunk
    total = 0.0
    pf = model["proposal_factor_features_per_level"]
    for n_samples, args in zip(model["num_proposal_samples_per_ray"], model["proposal_net_args_list"]):
        res = flops.resolutions(args["num_levels"], model["proposal_base_res"], args["max_res"])
        total += peaks.factor_bounds(res, pf, rays * n_samples, args["hidden_dim"], 1)["density"]
    f = model["field"]
    res = flops.resolutions(f["factor_num_levels"], model["base_res"], model["max_res"])
    total += peaks.factor_bounds(res, f["factor_features_per_level"], rays * model["num_nerf_samples_per_ray"],
                                 model["hidden_dim"], 1 + f["geo_feat_dim"])["density"]
    return total


def calibrate(cell: manifest.Cell, seeds, control_seeds, faults, hooks=None) -> Dict:
    """The readings that set the limits: the program's frames against the
    reference's on `seeds`, the control's (the reference in the precision
    below the configuration's) on `control_seeds`; each frame of
    `check_frames` poses of the arc."""
    tr = common.traffic(cell, hooks)
    model_cfg = common.model_section(cell, hooks)
    device = common.device_of(hooks)
    out: Dict = {"program": {}, "control": {}, "faults": {}}
    for seed in seeds:
        p = build(cell, tr, model_cfg, seed, device)
        ks = range(tr["check_frames"])
        pairs = [(p.frame(k), reference_frame(model_cfg, cell.config, tr, p.w0, p.poses, p.focal, p.size, p.start + k,
                                              nerf.FULL)) for k in ks]
        out["program"][str(seed)] = compare(pairs)
        print("program", seed, out["program"][str(seed)], flush=True)
    for seed in control_seeds:
        shapes, w0, _ = common.seeded_weights(model_cfg, tr["views"], seed, device)
        poses, focal, size, start = arc(tr, seed, device)
        pairs = [(reference_frame(model_cfg, cell.config, tr, w0, poses, focal, size, start + k, nerf.CONTROL),
                  reference_frame(model_cfg, cell.config, tr, w0, poses, focal, size, start + k, nerf.FULL))
                 for k in range(tr["check_frames"])]
        out["control"][str(seed)] = compare(pairs)
        print("control", seed, out["control"][str(seed)], flush=True)
    return out
