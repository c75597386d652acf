"""The reference-scale SIGNeRF edit pass on one NVIDIA GPU with the PyTorch
port: the twin of examples/north_star_pass.py.

Reference scale (the reference's README): about 100 dataset views, a 3x3
reference sheet and 20,000 `signerf` refinement steps. The script builds a
100-view 1024 px scene (a shaded sphere before a direction-dependent
backdrop), pretrains the `signerf` method on it (untimed: it stands in for
the existing nerfacto checkpoint that the reference edits), then times the
edit pass: dataset generation (a 3x3 sheet of 512 px cells, 1536 px, then
every view spliced into its last cell; SDXL + ControlNet-depth at its
published widths, 20 steps, random weights unless `sdxl_weights_path` holds
real ones), the dataset exchange and the refinement. It reports the walls
of each phase, the eval PSNR on the edited dataset and whether the edit
landed in the NeRF (mean |change| of view 0's render inside the edit mask
against outside it). Usage, from the repository root:

    python examples/north_star_pass_torch.py [n_views] [refine_steps] [pretrain_steps] [load_dir]
        [--device cuda|cpu] [--size 1024] [--out DIR] [--result FILE]
        [--mesh auto|none|data|data=K|production|data=K,tensor=T|tensor=T]

On more than one card (`--mesh`, as the train CLI's: auto takes every
visible card) the pass runs one process a card: the refinement's rays
split over all the cards, the views' chunks over the view groups (with a
tensor axis, each group of T cards holds one SDXL sharded over it and
runs its chunks together; `production` is (W / 2, 2)); rank 0's group
builds the sheet, rank 0 prints and writes the result (with "cards": W
and the mesh's shape in its notes); under a launcher (`torchrun --nproc-per-node
4 examples/north_star_pass_torch.py ...`) each process joins its group.

`load_dir` holds a checkpoint of this scene (the pretrain of an earlier run,
`OUT/out/signerf/checkpoints`), so the pretrain is skipped, as the
reference's `--load_dir` edits an existing NeRF. Times are host clocks
around work that ends in `torch.cuda.synchronize()`, and CUDA events around
the refinement's train calls. `--device cuda` (the default) raises when
torch sees no card. The result's `reduced` lists every cut from the
reference scale.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.cameras.cameras import Cameras  # noqa: E402
from signerf_tpu_torch.cameras.poses import circle_poses  # noqa: E402
from signerf_tpu_torch.data.datamanager import resize_bilinear_u8  # noqa: E402
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig  # noqa: E402
from signerf_tpu_torch.engine.checkpoints import latest_checkpoint  # noqa: E402
from signerf_tpu_torch.engine.train_step import make_train_step  # noqa: E402
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer, SIGNeRFTrainerConfig  # noqa: E402
from signerf_tpu_torch.method_configs import signerf_method  # noqa: E402
from signerf_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from signerf_tpu_torch.render import resolve_device  # noqa: E402
from signerf_tpu_torch.utils.images import load_gray, save_array_png  # noqa: E402
from signerf_tpu_torch.utils.microbench import TRAIN_KERNEL_GROUPS, card_name, kernel_breakdown  # noqa: E402

REFERENCE = dict(n_views=100, refine_steps=20000, pretrain_steps=8000, size=1024)
FOCAL_PER_PX = 1200.0 / 1024
# The edit box in world coordinates. It must hold visible surface: the mask is
# `near < rendered depth < far` along each ray, so a box buried inside the
# opaque unit sphere gives an empty mask. This one clips the sphere's top cap
# (z >= 0.6); it is mapped into the dataparser's scene space after setup.
AABB_WORLD_MIN = np.array([-0.65, -0.65, 0.6], np.float32)
AABB_WORLD_MAX = np.array([0.65, 0.65, 1.05], np.float32)
REFERENCE_VIEWS = 8
REFERENCE_RING = dict(radius=3.0, theta=55.0, phi=(0.0, 315.0))
SHEET = dict(rows=3, cols=3, downscale_factor=2)
SDXL_STEPS = 20
PROMPT = "a stone sphere"
EVAL_VIEWS = 4
PROFILE_STEPS = 5  # refinement steps under torch.profiler after the timed pass


def analytic_rgb(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Shaded unit sphere before a direction-dependent backdrop."""
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    p = o + d * t[..., None]
    return torch.where(hit[..., None], p.abs(), (0.55 + 0.3 * d).clamp(0.0, 1.0))


def dataset_poses(n_views: int) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses on a ring around the sphere."""
    return circle_poses(n_views, radius=3.0, theta=60.0, phi=(0.0, 360.0 * (n_views - 1) / n_views)).numpy()


def build_dataset(data: Path, n_views: int, size: int, device: torch.device) -> None:
    """Write `n_views` renders of the analytic scene at size x size and their
    transforms.json under `data`."""
    (data / "images").mkdir(parents=True, exist_ok=True)
    poses = dataset_poses(n_views)
    focal = FOCAL_PER_PX * size
    one = lambda v: torch.tensor([float(v)])  # noqa: E731
    frames = []
    for i in range(n_views):
        cams = Cameras(camera_to_worlds=torch.as_tensor(poses[i : i + 1, :3]), fx=one(focal), fy=one(focal),
                       cx=one(size / 2), cy=one(size / 2), width=size, height=size).to(device)
        rb = cams.generate_rays(0)
        save_array_png(analytic_rgb(rb.origins, rb.directions).cpu().numpy(), data / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
        if i % 20 == 0:
            print(f"  dataset image {i}/{n_views}", flush=True)
    (data / "transforms.json").write_text(json.dumps({
        "camera_model": "OPENCV", "fl_x": focal, "fl_y": focal, "cx": size / 2, "cy": size / 2, "w": size,
        "h": size, "frames": frames}))
    print("dataset written", flush=True)


def scene_aabb(transform: np.ndarray, scale: float):
    """The world edit box's corners in the dataparser's scene space
    (`transform` [3, 4], `scale`), as (min, max) tuples of floats."""
    t = np.asarray(transform, np.float32)
    corners = np.array(list(itertools.product(*zip(AABB_WORLD_MIN, AABB_WORLD_MAX))), np.float32)
    scene = scale * (corners @ t[:, :3].T + t[:, 3])
    return tuple(float(v) for v in scene.min(axis=0)), tuple(float(v) for v in scene.max(axis=0))


def world_to_scene_poses(c2w: np.ndarray, transform: np.ndarray, scale: float) -> np.ndarray:
    """World camera-to-world poses [n, 3, 4] -> the dataparser's scene space."""
    t = np.asarray(transform, np.float32)
    rot = np.einsum("ij,njk->nik", t[:, :3], c2w[:, :3, :3])
    trans = scale * (c2w[:, :3, 3] @ t[:, :3].T + t[:, 3])
    return np.concatenate([rot, trans[..., None]], axis=-1)


def reference_poses(transform: np.ndarray, scale: float) -> np.ndarray:
    ring = circle_poses(REFERENCE_VIEWS, **REFERENCE_RING).numpy()[:, :3]
    return world_to_scene_poses(ring, transform, scale)


def edit_landing(pre: np.ndarray, post: np.ndarray, mask_path: Path) -> Dict[str, float]:
    """Mean |post - pre| inside the mask against outside it, over [H, W, 3]
    renders of one view before and after the refinement, and the mask's
    coverage. The mask is read with the port's PNG decoder (and resized by
    the loader's bilinear rule if it is not at the renders' size)."""
    m = load_gray(mask_path)
    if m.shape != pre.shape[:2]:
        m = resize_bilinear_u8(m[..., None], pre.shape[1], pre.shape[0])[..., 0]
    mask = m.astype(np.float32)[..., None] / 255.0
    delta = np.abs(post - pre)
    masked = float((delta * mask).sum() / max(float(mask.sum()) * 3, 1.0))
    unmasked = float((delta * (1 - mask)).sum() / max(float((1 - mask).sum()) * 3, 1.0))
    return {"coverage": float(mask.mean()), "masked": masked, "unmasked": unmasked,
            "ratio": masked / max(unmasked, 1e-9)}


def render_view(trainer: SIGNeRFTrainer, i: int) -> np.ndarray:
    """Camera i of the datamanager through the eval render, with camera i's
    appearance code (appearance mode "index"), as [H, W, 3] float."""
    dm = trainer.pipeline.datamanager
    rb = dm.cameras.generate_rays(camera_index=i)
    h, w = dm.cameras.height, dm.cameras.width
    out = trainer.pipeline._render(rb.reshape((h * w,)), appearance_mode="index")
    return out["rgb"].reshape(h, w, 3).float().cpu().numpy()


def trainer_config(root: Path, data: Path, pretrain_steps: int, load_dir: Optional[Path]) -> SIGNeRFTrainerConfig:
    cfg = signerf_method()
    cfg.output_dir = root / "out"
    cfg.pipeline.datamanager.dataparser.data = data
    cfg.pipeline.datamanager.dataparser.downscale_factor = 1  # keep the full size
    cfg.pipeline.model.far_plane = 8.0
    cfg.max_num_iterations = pretrain_steps
    cfg.steps_per_call = 100
    cfg.steps_per_save = 10000
    cfg.load_dir = load_dir
    gen = cfg.pipeline.dataset_generator
    gen.path = root / "generations"
    gen.dataset_name = "edit0"
    gen.rows, gen.cols, gen.downscale_factor = SHEET["rows"], SHEET["cols"], SHEET["downscale_factor"]
    gen.masking_mode = "aabb"
    gen.aabb_min, gen.aabb_max = tuple(AABB_WORLD_MIN), tuple(AABB_WORLD_MAX)  # mapped after setup
    # The generator's own batch (4 views a diffuse call) is kept. The JAX
    # script sets 1 after a TPU measurement that favoured one-view programs;
    # on the card a chunk of 4 is what the edit pass runs by default.
    gen.diffuser.num_inference_steps = SDXL_STEPS
    gen.diffuser.prompt = PROMPT
    return cfg


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_views", nargs="?", type=int, default=REFERENCE["n_views"])
    ap.add_argument("refine_steps", nargs="?", type=int, default=REFERENCE["refine_steps"])
    ap.add_argument("pretrain_steps", nargs="?", type=int, default=REFERENCE["pretrain_steps"])
    ap.add_argument("load_dir", nargs="?", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=REFERENCE["size"], help="image side in pixels")
    ap.add_argument("--out", type=Path, default=None, help="output tree (default outputs/north_star_torch[_Nv])")
    ap.add_argument("--result", type=Path, default=None, help="also write the result JSON here")
    ap.add_argument("--mesh", default="auto",
                    help="auto | none | data | data=K | production | data=K,tensor=T | tensor=T (see the train CLI)")
    return ap.parse_args(argv)


def main(
    argv: Optional[Sequence[str]] = None,
    configure: Optional[Callable[[SIGNeRFTrainerConfig], None]] = None,
    make_diffuser: Optional[Callable[[DiffuserConfig], Diffuser]] = None,
    reduced: Sequence[str] = (),
    mesh: Optional[mesh_lib.DataMesh] = None,
) -> Dict:
    """Run the pass; returns the result written to the output tree.

    `configure(cfg)` edits the trainer config before setup, `make_diffuser`
    builds the generator's diffuser from its config (default: the
    configured backend), and `reduced` names the caller's own cuts from the
    reference scale (a narrowed model, say); the tests and the smoke test
    use them. `mesh`: run as this rank of a data-parallel group (else
    `--mesh` decides; spawned ranks get `argv` only)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if mesh is not None:
        return _pass(mesh, argv, configure, make_diffuser, reduced)
    shape = mesh_lib.mesh_from_spec(args.mesh, mesh_lib.visible_devices(dev))
    if not mesh_lib.launched() and shape is None:
        return _pass(None, argv, configure, make_diffuser, reduced)
    if not mesh_lib.launched() and shape.size > 1 and (configure or make_diffuser or reduced):
        raise ValueError("spawned ranks get argv only: pass mesh= for configure, make_diffuser or reduced")
    root = _root(args)
    out = mesh_lib.run(args.mesh, dev, root, _pass, (argv, configure, make_diffuser, reduced))
    return out if isinstance(out, dict) else json.loads((root / "north_star_result_torch.json").read_text())


def _root(args: argparse.Namespace) -> Path:
    return args.out or Path("outputs/north_star_torch" if args.n_views == REFERENCE["n_views"]
                            else f"outputs/north_star_torch_{args.n_views}v")


def _pass(mesh, argv, configure, make_diffuser, reduced) -> Dict:
    """The pass on this rank (`mesh` None: one device); the result on rank 0, {} elsewhere."""
    args = parse_args(argv)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    cuda = dev.type == "cuda"
    cards = 1 if mesh is None else mesh.world_size
    main_rank = mesh is None or mesh.is_main
    log = print if mesh is None else mesh.print
    hardware = f"{cards}x {card_name()}" if cuda else "CPU" if cards == 1 else f"CPU, {cards} ranks"
    loaded_step = None
    if args.load_dir is not None:
        ckpt = latest_checkpoint(args.load_dir)
        if ckpt is None:
            raise FileNotFoundError(f"{args.load_dir} holds no step-*.pt or step-*.ckpt checkpoint to edit")
        loaded_step = int(re.search(r"step-(\d+)", ckpt.name).group(1))
    n_views = args.n_views
    root = _root(args)
    data = root / "data"
    if main_rank and not (data / "transforms.json").exists():
        build_dataset(data, n_views, args.size, dev)
    if mesh is not None:
        mesh.barrier()

    cfg = trainer_config(root, data, args.pretrain_steps, args.load_dir)
    if configure is not None:
        configure(cfg)
    gen_cfg = cfg.pipeline.dataset_generator
    diffuser = make_diffuser(gen_cfg.diffuser) if make_diffuser is not None else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def synced() -> float:
        """The host clock once the device, and with a mesh every rank, is done."""
        if cuda:
            torch.cuda.synchronize()
        if mesh is not None:
            mesh.barrier()
        return time.perf_counter()

    phases: Dict[str, float] = {}
    t0 = synced()
    trainer = SIGNeRFTrainer(cfg, dev, mesh=mesh)
    trainer.setup(diffuser=diffuser)
    phases["setup"] = synced() - t0
    log(f"setup: {phases['setup']:.1f}s", flush=True)

    if args.load_dir is None:
        t0 = synced()
        trainer.train()
        phases["pretrain"] = synced() - t0
        log(f"pretrain {args.pretrain_steps} steps: {phases['pretrain']:.1f}s", flush=True)
    else:
        phases["pretrain"] = 0.0
        log(f"pretrain skipped (loaded checkpoint from {args.load_dir})", flush=True)

    dpo = trainer.pipeline.datamanager.outputs
    gen_cfg.aabb_min, gen_cfg.aabb_max = scene_aabb(dpo.dataparser_transform, dpo.dataparser_scale)
    log(f"scene-space edit AABB: {gen_cfg.aabb_min} .. {gen_cfg.aabb_max}", flush=True)
    ref = reference_poses(dpo.dataparser_transform, dpo.dataparser_scale)

    # --- timed edit pass: generation ---
    trainer.step = 0
    t0 = synced()
    generated = trainer.generate_dataset(reference_camera_to_worlds=ref)
    phases["generation"] = synced() - t0
    gen = trainer.pipeline.dataset_generator
    timings = gen.last_timings
    batch = max(1, int(gen_cfg.generation_batch_size))
    chunk_s = timings.get("view_s", [])
    # The first chunk warms the per-view programs; the rest are the steady
    # state. A chunk holds `batch` views (the last may hold fewer). With a
    # mesh these are rank 0's chunks, dealt every `cards`-th.
    full = [s for i, s in enumerate(chunk_s) if i > 0 and ((i * cards) + 1) * batch <= n_views]
    warm_marginal = float(np.median(full)) / batch if full else None
    log(f"dataset generation ({n_views} views + {REFERENCE_VIEWS} references, "
        f"{gen_cfg.rows}x{gen_cfg.cols} sheet, {gen_cfg.diffuser.num_inference_steps} SDXL steps, batch {batch}): "
        f"{phases['generation']:.1f}s (sheet {timings.get('sheet_s', 0):.1f}s, warm per-view marginal "
        f"{float('nan') if warm_marginal is None else warm_marginal:.2f}s)", flush=True)

    # --- the sheet again: the first paid one-time costs (SDXL's creation,
    # cuDNN's algorithm search); this one is the steady state ---
    t0 = synced()
    if main_rank:
        gen.generate_reference_sheet(gen._cameras_from_poses(ref))
    sheet_warm_s = synced() - t0
    log(f"warm sheet re-measure: {sheet_warm_s:.1f}s", flush=True)

    # --- timed edit pass: exchange + refinement ---
    t0 = synced()
    trainer.exchange_training_dataset(generated)
    phases["exchange"] = synced() - t0
    log(f"exchange: {phases['exchange']:.1f}s", flush=True)

    pre_render0 = render_view(trainer, 0) if main_rank else None  # untimed: the edit landing's "before"

    cfg.max_num_iterations = args.refine_steps
    call_events: List = []
    if cuda:  # CUDA events around each train call (steps_per_call steps)
        train_fn = trainer._train_fn

        def timed_train_fn(*a):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = train_fn(*a)
            ev[1].record()
            call_events.append(ev)
            return out

        trainer._train_fn = timed_train_fn
    t0 = synced()
    trainer.train()
    phases["refine"] = synced() - t0
    rays = cfg.pipeline.datamanager.train_num_rays_per_batch
    step_ms = sorted(s.elapsed_time(e) / cfg.steps_per_call for s, e in call_events[1:] or call_events)
    step_median = step_ms[len(step_ms) // 2] if step_ms else float("nan")
    refine_rays_per_s = rays / step_median * 1e3 if cuda else rays * args.refine_steps / max(phases["refine"], 1e-9)
    log(f"refine {args.refine_steps} steps: {phases['refine']:.1f}s; step median {step_median:.3f} ms "
        f"(CUDA events over {len(step_ms)} calls of {cfg.steps_per_call} steps, the first left out), "
        f"{refine_rays_per_s:.0f} rays/s", flush=True)

    # --- eval PSNR on the edited dataset, and did the edit land (rank 0) ---
    t0 = synced()
    dm = trainer.pipeline.datamanager
    n_eval = min(EVAL_VIEWS, len(dm.cameras))
    psnrs = []
    post_render0 = None
    for i in range(n_eval if main_rank else 0):
        pred = render_view(trainer, i)
        target = dm.images[i].float().cpu().numpy() / 255.0
        psnrs.append(-10 * math.log10(max(float(np.mean((pred - target) ** 2)), 1e-12)))
        if i == 0:
            post_render0 = pred
            save_array_png(pred, root / "refined_render_0.png")
    mask_path = sorted((generated / "masks").glob("mask_*.png"))[0]
    landing = edit_landing(pre_render0, post_render0, mask_path) if main_rank else None
    phases["eval"] = synced() - t0
    notes = []
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        step = make_train_step(trainer.pipeline.model, trainer.optimizer, dm.cameras, dm.sampler_settings(),
                               mesh=mesh)
        index = itertools.count(trainer.step)
        groups = TRAIN_KERNEL_GROUPS if mesh is None else [*TRAIN_KERNEL_GROUPS, ("all-reduce (NCCL)", ("nccl",))]
        bd = kernel_breakdown(lambda: step(next(index), dm.images, dm.mask_indices, trainer._generator),
                              groups, iters=PROFILE_STEPS, warmup=1)
        ranks = [(step_median, peak, bd)] if mesh is None else mesh.gather_objects((step_median, peak, bd))
    if not main_rank:
        return {}
    log(f"edit-landing check (view 0): masked-region mean |delta| {landing['masked']:.4f} vs unmasked "
          f"{landing['unmasked']:.4f} (ratio {landing['ratio']:.1f}x), mask coverage {landing['coverage']:.4f}",
          flush=True)
    log(f"eval PSNR on the edited dataset ({n_eval} views): {np.mean(psnrs):.2f} dB "
        f"(per view {['%.1f' % p for p in psnrs]})", flush=True)

    if cuda:
        notes.append(f"refinement step median {step_median:.3f} ms from CUDA events around the train calls "
                     f"({len(step_ms)} calls of {cfg.steps_per_call} steps, the first left out), {rays} rays a step"
                     + ("" if mesh is None else f" over {cards} cards, {rays // cards} a card"))
        if mesh is not None:
            notes.append(f"mesh (data, tensor) = ({mesh.view_groups}, {mesh.tensor}): generation "
                         f"{phases['generation'] / n_views:.3f} s a view over {cards} cards (the generation wall "
                         f"over {n_views} views; chunks of {batch} views dealt round-robin over {mesh.view_groups} "
                         f"view groups of {mesh.tensor} card(s), SDXL sharded over each group's cards)")
        for rank, (rank_median, rank_peak, rank_bd) in enumerate(ranks):
            who = "" if mesh is None else f"rank {rank}: "
            groups_ms = "; ".join(f"{k} {v:.3f}" for k, v in rank_bd["groups_ms"].items())
            if mesh is not None:
                notes.append(f"{who}refinement step median {rank_median:.3f} ms (CUDA events)")
            notes.append(f"{who}peak device memory {rank_peak:.2f} GiB (max_memory_allocated over the whole run)")
            notes.append(f"{who}refinement profile after the timed pass, {PROFILE_STEPS} steps under torch.profiler: "
                         f"span {rank_bd['span_ms']:.3f} ms a step, device busy {rank_bd['busy_ms']:.3f} ms, idle "
                         f"share {rank_bd['idle_share']:.4f}; device ms a step: {groups_ms}")
        log("\n".join(notes), flush=True)
    sdxl = gen_cfg.diffuser
    if sdxl.mode != "custom" and not sdxl.sdxl_weights_path:
        notes.append("SDXL + ControlNet-depth at the published widths with seeded random weights: the work's "
                     "shapes are real, the edit's content is not")

    edit_pass = phases["generation"] + phases["exchange"] + phases["refine"]
    log(f"\n==== NORTH STAR SUMMARY ({hardware}) ====", flush=True)
    for k, v in phases.items():
        log(f"  {k:14s} {v:9.1f}s", flush=True)
    log(f"  EDIT PASS      {edit_pass:9.1f}s  ({edit_pass / 60:.1f} min)", flush=True)

    cuts = [f"{name} {getattr(args, name)} (reference {want})" for name, want in
            (("n_views", REFERENCE["n_views"]), ("refine_steps", REFERENCE["refine_steps"]), ("size", REFERENCE["size"]))
            if getattr(args, name) != want]
    pretrained = args.pretrain_steps if loaded_step is None else loaded_step
    if pretrained != REFERENCE["pretrain_steps"]:
        cuts.append(f"pretrain_steps {pretrained}{'' if loaded_step is None else ' (the loaded checkpoint)'} "
                    f"(reference {REFERENCE['pretrain_steps']})")
    cuts += list(reduced)
    sheet_px = gen._layout()
    warm_terms = [sheet_warm_s, phases["exchange"], phases["refine"]]
    result = {
        "script": " ".join(["examples/north_star_pass_torch.py", *(argv if argv is not None else sys.argv[1:])]),
        "commit": _commit(),
        "date": time.strftime("%Y-%m-%d"),
        "hardware": hardware,
        "cards": cards,
        "n_views": n_views,
        "refine_steps": args.refine_steps,
        "pretrain_steps": 0 if args.load_dir is not None else args.pretrain_steps,
        "loaded_checkpoint": str(args.load_dir) if args.load_dir is not None else None,
        "phases_s": {k: round(v, 3) for k, v in phases.items()},
        "edit_pass_s": round(edit_pass, 3),
        "edit_pass_min": round(edit_pass / 60, 2),
        "sheet_s": round(timings.get("sheet_s", 0.0), 3),
        "sheet_warm_s": round(sheet_warm_s, 3),
        "refine_rays_per_s": int(refine_rays_per_s),
        "warm_per_view_marginal_s": None if warm_marginal is None else round(warm_marginal, 3),
        "view_s_first": round(chunk_s[0], 3) if chunk_s else None,
        "eval_psnr_db": round(float(np.mean(psnrs)), 2),
        "edit_mask_coverage": round(landing["coverage"], 4),
        "edit_landing_masked_delta": round(landing["masked"], 4),
        "edit_landing_unmasked_delta": round(landing["unmasked"], 4),
        "edit_landing_ratio": round(landing["ratio"], 2),
        "generation_batch_size": batch,
        "reduced": cuts,
        "notes": notes,
        "image_px": args.size,
        "sheet": f"{gen_cfg.rows}x{gen_cfg.cols} at {sheet_px.width}x{sheet_px.height}px (cells "
                 f"{sheet_px.cell_width}px, downscale {gen_cfg.downscale_factor})",
        # the warm terms of this run: the sheet again, the per-view marginal
        # times the views, the exchange and the refinement as run
        "warm_single_chip_edit_pass_min": None if warm_marginal is None else round(
            (sum(warm_terms) + warm_marginal * n_views) / 60, 2),
    }
    log(json.dumps(result), flush=True)
    (root / "north_star_result_torch.json").write_text(json.dumps(result, indent=2))
    if args.result is not None:
        args.result.parent.mkdir(parents=True, exist_ok=True)
        args.result.write_text(json.dumps(result, indent=2))
    return result


def _commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, timeout=10,
                             cwd=Path(__file__).resolve().parents[1])
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


if __name__ == "__main__":
    main()
