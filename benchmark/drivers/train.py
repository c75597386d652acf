"""Training traffic: a configuration's train step on the seeded scene, on
one card or data-parallel over `ranks` cards.

Set-up renders the scene's views on the device, fills the program's model
with seeded weights (on a mesh, rank 0's broadcast, as the trainer does),
builds its optimizer and its train call (`engine.train_step.make_train_step`,
one optimizer step a call, in as many micro-batches as the traffic says;
on a mesh `rays` on every rank, the gradients averaged by the program's
all-reduce) and drives that call through its first `check_steps` steps
from the seed, which also warms every shape. The same objects then run the
window. After the window the plain reference follows the first steps from
the same weights and the same sampler draws, and the run compares each
step's loss (`loss_gap`), the first gradient as the optimizer got it
(from Adam's first moment after one step) by groups of leaves
(`grad_diff.<group>`, `grad_gap.<group>`) and each leaf's change over the
steps (`change_gap`); on a mesh also every rank's parameters after the
window against rank 0's (`rank_gap`, exact).

End-to-end: `train_rays_per_s`, every rank's rays of every step over the
whole window; `setup_s`, from the process' start to the window's.
"""

from __future__ import annotations

import gc
import json
import pickle
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

import torch

from drivers import nerf_common as common
from harness import flops, guard, manifest, peaks, trace
from harness.report import LayerContext, Outcome
from reference import nerf
from reference import train as ref_train

# The sampler's generator on rank r: seeded from the run's seed, rank 0's
# at seed + 1.
RANK_STRIDE = 1_000_003


def sampler_seed(seed: int, rank: int) -> int:
    return int(seed) + 1 + RANK_STRIDE * rank


def build(cell: manifest.Cell, tr: Dict, model_cfg: Dict, seed: int, device, mesh=None) -> types.SimpleNamespace:
    """The scene, the seeded weights and the program's train call."""
    from signerf_tpu_torch.engine.train_step import SamplerSettings, make_train_step
    from signerf_tpu_torch.ops.lpips import full_f32_convolutions

    full_f32_convolutions()  # as the train CLI runs LPIPS
    scene = common.make_scene(tr, device)
    shapes, w0, lp = common.seeded_weights(model_cfg, tr["views"], seed, device)
    model = common.program_model(model_cfg, tr["views"]).to(device)
    common.load_into_program(model, shapes, w0, lp)
    if mesh is not None:
        mesh.broadcast_module_(model)
    optimizer = common.program_optimizer(cell.config["optimizers"], model)
    patch = cell.config["datamanager"]["patch_size"]
    ranks = 1 if mesh is None else mesh.world_size
    train_fn = make_train_step(model, optimizer, common.program_cameras(scene), SamplerSettings(
        num_rays=tr["rays"] * ranks, patch_size=patch, micro_batches=tr["micro_batches"] * ranks), mesh=mesh)
    rank = 0 if mesh is None else mesh.rank
    return types.SimpleNamespace(scene=scene, shapes=shapes, w0=w0, lp=lp, model=model, optimizer=optimizer,
                                 train_fn=train_fn, patch=patch,
                                 gen=torch.Generator(device=device).manual_seed(sampler_seed(seed, rank)))


def program_check(p: types.SimpleNamespace, steps: int) -> Dict:
    """The program's first steps: each step's loss, the first gradient's
    leaf norms (Adam's first moment after one step over 1 - b1), and each
    leaf's change over the steps. Device scalars; read them with `floats`."""
    states: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    grads: Dict[str, torch.Tensor] = {}
    for step in range(steps):
        states.append(p.gen.get_state())
        metrics = p.train_fn(step, p.scene.images, None, p.gen)
        losses.append(metrics["total_loss"].detach().clone())
        if step == 0:
            for group, names in p.optimizer.names.items():
                for name, m in zip(names, p.optimizer.state[group]["m"]):
                    grads[name] = m / (1.0 - nerf.B1)
    params = dict(p.model.named_parameters())
    change = {name: (params[name].detach() - p.w0[name]).norm() for name in p.shapes}
    return {"states": states, "losses": losses, "grads": grads, "change": change}


def floats(check: Dict) -> Dict:
    return {"states": check["states"], "losses": [float(v) for v in check["losses"]],
            "grads": {k: float(v.norm()) for k, v in check["grads"].items()},
            "grad_tensors": {k: v.clone() for k, v in check["grads"].items()},
            "change": {k: float(v) for k, v in check["change"].items()}}


def reference_check(cell: manifest.Cell, tr: Dict, model_cfg: Dict, scene, w0, lp, patch: int,
                    states: Optional[List[List[torch.Tensor]]], prec: nerf.Precision, start_states=None) -> Dict:
    """The reference's first steps from the same weights and draws:
    `states[step][rank]`, every rank's generator state before each step,
    or with `states` None from `start_states` on, following the reference's
    own draws (the control's case)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.clone() for k, v in w0.items()}
    adam = nerf.Adam(cell.config["optimizers"], params)
    losses, grads, used = [], {}, []
    current = start_states
    for s in range(tr["check_steps"]):
        current = states[s] if states is not None else current
        used.append(current)
        loss, g, current = ref_train.train_step(params, adam, s, current, scene, model_cfg, tr["rays"], patch, lp,
                                                prec, tr["reference_block_rays"])
        losses.append(loss)
        if s == 0:
            grads = {k: float(v.norm()) for k, v in g.items()}
            grad_tensors = g
    change = {k: float((params[k] - w0[k]).norm()) for k in w0}
    return {"states": used, "losses": losses, "grads": grads, "grad_tensors": grad_tensors, "change": change,
            "params": params}


def grad_diffs(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's first gradient: the norm of the two sides' difference
    against the larger of the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref["grads"].values())
    return {k: float((prog["grad_tensors"][k] - ref["grad_tensors"][k]).norm()) / max(ref["grads"][k], med)
            for k in ref["grads"]}


def leaf_group(name: str) -> str:
    """The group of a leaf whose first gradient one number holds: each
    proposal field; each level of the base field's tables (its three
    axes' lines, which K4 and K6 write); the predicted-normals head; the
    rest of the base field (its MLP, the colour head, the appearance codes)."""
    parts = name.split(".")
    if parts[0].startswith("proposal"):
        return parts[0]
    if parts[1] == "encoding":
        return "base_l" + parts[2].split("_")[1]
    return "pred_normals" if parts[1] == "mlp_pred_normals" else "base_mlp"


def grad_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's first gradient: the gap between the two sides' norms
    against the larger of the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref["grads"].values())
    return {k: common.rel_gap(prog["grads"][k], ref["grads"][k], max(ref["grads"][k], med)) for k in ref["grads"]}


def by_group(prefix: str, leaves: Dict[str, float]) -> Dict[str, float]:
    """`<prefix>.<group>`: the median leaf of each group (`leaf_group`)."""
    groups: Dict[str, List[float]] = {}
    for name, value in leaves.items():
        groups.setdefault(leaf_group(name), []).append(value)
    return {f"{prefix}.{g}": statistics.median(v) for g, v in sorted(groups.items())}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers: each step's loss (the widest relative gap); the first
    gradient by groups of leaves (`leaf_group`), so that a fault confined to
    one field or one level of tables shows, as each group's median leaf's
    difference (`grad_diff.<group>`, first order in rounding noise) and gap
    of norms (`grad_gap.<group>`, second order); each leaf's change over the
    steps (the widest gap of the norms). Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone under
    Adam, and are left out of the change. A cell holds the numbers its
    limits name."""
    med = statistics.median(ref["grads"].values())
    moved = [k for k in ref["grads"] if ref["grads"][k] >= 1e-3 * med]
    return {
        "loss_gap": max(common.rel_gap(a, b, abs(b)) for a, b in zip(prog["losses"], ref["losses"])),
        **by_group("grad_diff", grad_diffs(prog, ref)),
        **by_group("grad_gap", grad_gaps(prog, ref)),
        "change_gap": common.widest_leaf_gap(prog["change"], ref["change"], moved),
    }


def held(readings: Dict[str, float], lim: Dict[str, float]):
    """(name, value, limit) of every number with a limit; a limit with no
    reading is a failed check."""
    return [(name, readings.get(name, float("nan")), limit) for name, limit in lim.items()]


def detail(prog: Dict, ref: Dict) -> Dict:
    """What `compare`'s numbers come from, for the calibration's record:
    each step's two losses, every leaf's first-gradient difference
    (`grad_diffs`), gap of first-gradient norms and gap of change norms,
    each against the larger of its reference and the median leaf's."""
    med = statistics.median(ref["grads"].values())
    moved = [k for k in ref["grads"] if ref["grads"][k] >= 1e-3 * med]
    med_change = statistics.median(ref["change"][k] for k in moved)
    return {"losses": [prog["losses"], ref["losses"]], "leaf_diffs": grad_diffs(prog, ref),
            "leaf_grad_gaps": grad_gaps(prog, ref),
            "leaf_change_gaps": {k: common.rel_gap(prog["change"][k], ref["change"][k],
                                                   max(ref["change"][k], med_change)) for k in moved}}


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: manifest.Cell, args, t0: float, hooks) -> Outcome:
    tr = common.traffic(cell, hooks)
    t0_wall = time.time() - (time.perf_counter() - t0)
    if tr["ranks"] == 1:
        return run_rank(None, cell, vars(args), t0_wall, hooks)
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    device = common.device_of(hooks)
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        mesh_lib.spawn(rank_main, (cell.name, vars(args), t0_wall, tmp, hooks), tr["ranks"], Path(tmp),
                       device_type=device.type, join_timeout_s=float(tr["join_timeout_s"]))
        outcome = pickle.loads((Path(tmp) / "outcome.pkl").read_bytes())
        for r in range(tr["ranks"]):
            found = Path(tmp) / f"modules.{r}.json"
            outcome.rank_modules[r] = json.loads(found.read_text()) if found.is_file() else ["(no report)"]
        return outcome


def rank_main(mesh, cell_name: str, args: Dict, t0_wall: float, out_dir: str, hooks) -> int:
    """One rank of a data-parallel cell, in a spawned process; rank 0
    writes the outcome, and every rank the forbidden modules it holds once
    the window has closed, for the parent to refuse a result on."""
    cell = manifest.find_cell(cell_name, manifest.load_manifest())
    if hooks is not None and getattr(hooks, "fault", None) == "no_exchange":
        mesh.all_mean_ = lambda flat: flat  # the exchange between ranks left out
    if hooks is not None and getattr(hooks, "plant_module", None) is not None:
        rank, name = hooks.plant_module  # a rank that loads a forbidden module on its path
        if mesh.rank == rank:
            sys.modules[name] = types.ModuleType(name)
    outcome = run_rank(mesh, cell, args, t0_wall, hooks)
    (Path(out_dir) / f"modules.{mesh.rank}.json").write_text(json.dumps(guard.forbidden_modules()))
    if mesh.is_main:
        (Path(out_dir) / "outcome.pkl").write_bytes(pickle.dumps(outcome))
    return 0


def run_rank(mesh, cell: manifest.Cell, args: Dict, t0_wall: float, hooks) -> Optional[Outcome]:
    """The cell on this process' card (`mesh` None) or as one rank of a
    mesh; rank 0 returns the outcome, the others None."""
    args = types.SimpleNamespace(**args)
    tr = common.traffic(cell, hooks)
    model_cfg = common.model_section(cell, hooks)
    device = common.device_of(hooks) if mesh is None else mesh.device
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    main = mesh is None or mesh.is_main
    ranks = 1 if mesh is None else mesh.world_size

    def decide(flag: bool) -> bool:
        """Rank 0's decision on every rank (over the host group: no card's
        stream waits for it)."""
        return flag if mesh is None else mesh.broadcast_flag(flag, group=mesh.host_group())

    p = build(cell, tr, model_cfg, args.seed, device, mesh)
    check = program_check(p, tr["check_steps"])
    sync()
    if mesh is not None:
        mesh.barrier()
    setup_s = time.time() - t0_wall

    # The window: the same train call, from the step after the check's.
    step = tr["check_steps"]
    done = 0
    layer_trace = None
    unit_wall = float("nan")
    images, gen, train_fn = p.scene.images, p.gen, p.train_fn
    t_start = time.perf_counter()
    while True:
        train_fn(step, images, None, gen)
        step += 1
        done += 1
        if done % tr["sync_every"]:
            continue
        sync()
        now = time.perf_counter() - t_start
        if args.trace and layer_trace is None and decide(now >= min(tr["trace_after_s"], args.seconds)):
            unit_wall, base = now / done, step

            def one(i, base=base):
                train_fn(base + i, images, None, gen)

            if main:
                layer_trace = trace.profile(torch, one, tr["trace_steps"])
            else:
                for i in range(tr["trace_steps"]):
                    one(i)
                sync()
                layer_trace = True
            step += tr["trace_steps"]
            done += tr["trace_steps"]
            continue
        if decide(now >= args.seconds):
            break
    window_s = time.perf_counter() - t_start
    prog = floats(check)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    rank_gap = None
    if mesh is not None:
        flat = torch.cat([q.detach().reshape(-1) for q in p.model.parameters()])
        mine = flat.clone()
        mesh.broadcast_([flat])
        gathered = mesh.gather_objects((float((mine - flat).abs().max()), peak, prog["states"]))
        rank_gap = max(g[0] for g in gathered)
        peak = max(g[1] for g in gathered)
        states = [[g[2][s] for g in gathered] for s in range(tr["check_steps"])]
        del flat, mine
    else:
        states = [[s] for s in prog["states"]]
    scene, w0, lp, patch = p.scene, p.w0, p.lp, p.patch
    del p, train_fn, check
    free()
    if not main:
        return None

    t_ref = time.perf_counter()
    ref = reference_check(cell, tr, model_cfg, scene, w0, lp, patch, states, nerf.FULL)
    print(f"reference: {tr['check_steps']} steps of {ranks} rank(s) in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr, flush=True)
    readings = compare(prog, ref)
    if rank_gap is not None:
        readings["rank_gap"] = rank_gap
    if hooks is not None and getattr(hooks, "readings", None) is not None:
        hooks.readings.update(readings, losses=(prog["losses"], ref["losses"]), detail=detail(prog, ref))
    checks = held(readings, common.limits(cell, hooks))

    layer = None
    if args.trace:
        per_ray = flops.nerfacto_per_ray(model_cfg)
        layer = LayerContext(cell=cell.name, config=cell.config, traffic=tr, trace=layer_trace, unit_wall_s=unit_wall,
                             memory_peak_bytes=peak, extra={
                                 "peak_s_per_unit": per_ray.seconds_at_peak(tr["rays"], True, peaks.BF16_FLOP_PER_S,
                                                                            peaks.F32_FLOP_PER_S),
                                 "factor_bound_ms_per_unit": train_factor_bound_ms(model_cfg, tr["rays"])})
    return Outcome(end_to_end={"train_rays_per_s": done * tr["rays"] * ranks / window_s, "setup_s": setup_s},
                   checks=checks, attempted=done, failed=0, memory_peak_bytes=peak, device_kind=kind,
                   device_count=ranks, layer=layer)


def train_factor_bound_ms(model: Dict, rays: int) -> float:
    """The least ms of one rank's step of factor-grid work: each proposal
    field's fused density forward and its backward to the tables; the base
    field's encode, its backward, and with gradient normals the grad-dot
    contraction and its backward (else its fused density and backward)."""
    total = 0.0
    pf = model["proposal_factor_features_per_level"]
    for n_samples, args in zip(model["num_proposal_samples_per_ray"], model["proposal_net_args_list"]):
        res = flops.resolutions(args["num_levels"], model["proposal_base_res"], args["max_res"])
        b = peaks.factor_bounds(res, pf, rays * n_samples, args["hidden_dim"], 1)
        total += b["density"] + b["density_bwd"]
    f = model["field"]
    res = flops.resolutions(f["factor_num_levels"], model["base_res"], model["max_res"])
    b = peaks.factor_bounds(res, f["factor_features_per_level"], rays * model["num_nerf_samples_per_ray"],
                            model["hidden_dim"], 1 + f["geo_feat_dim"])
    if model["predict_normals"] and model["use_gradient_normals"]:
        total += b["encode"] + b["encode_bwd"] + b["grad_dot"] + b["grad_dot_bwd"]
    else:
        total += b["density"] + b["density_bwd"]
    return total


def plant_half_batch():
    """A fault in the program's sampler: the batch's second half repeats its
    first (whole patches), so the step's mean is over half the batch."""
    from signerf_tpu_torch.engine import train_step as ts

    original = ts._sample_indices

    def half(*a, **kw):
        idx = original(*a, **kw)
        h = idx.shape[0] // 2
        return torch.cat([idx[:h], idx[:h]])

    ts._sample_indices = half
    return lambda: setattr(ts, "_sample_indices", original)


def plant_base_level(level: int):
    """A fault in the base field's backward to its tables: one level's
    gradient (its three axes' lines) comes out zero, as a tables half that
    skipped a level would leave it."""
    original = common.load_into_program

    def load(model, *a, **kw):
        original(model, *a, **kw)
        params = dict(model.named_parameters())
        for axis in range(3):
            params[f"field.encoding.line_{level}_{axis}"].register_hook(torch.zeros_like)

    common.load_into_program = load
    return lambda: setattr(common, "load_into_program", original)


FAULTS = {"half_batch": plant_half_batch, "base_level_4": lambda: plant_base_level(4),
          "base_level_7": lambda: plant_base_level(7)}


def calibrate(cell: manifest.Cell, seeds, control_seeds, faults, hooks=None, looks=()) -> Dict:
    """The readings that set the limits, each with its `detail` (every
    leaf's first-gradient difference among it): the program against the
    reference on `seeds` (on one card from the set-up's checked steps; a
    mesh's from a short window a seed on all its ranks); the control (the
    reference in the precision below the configuration's, over every rank's
    batch) and each fault on `control_seeds`. A fault is planted in the
    program (`FAULTS`) or, for a mesh, in the reference put in its place
    (`no_exchange`: each rank steps on its own batch's gradient). A look
    (`configured_precision`: the reference with what the configuration
    states in bfloat16 rounded so, against the float32 reference) is read
    on `control_seeds`, to tell rounding from a fault."""
    tr = common.traffic(cell, hooks)
    ranks = tr["ranks"]
    model_cfg = common.model_section(cell, hooks)
    device = common.device_of(hooks)
    patch = cell.config["datamanager"]["patch_size"]
    out: Dict = {"program": {}, "control": {}, "faults": {f: {} for f in faults}, "looks": {k: {} for k in looks},
                 "detail": {}}

    def program_readings(seed, key):
        p = build(cell, tr, model_cfg, seed, device)
        prog = floats(program_check(p, tr["check_steps"]))
        scene, w0, lp = p.scene, p.w0, p.lp
        del p
        free()
        ref = reference_check(cell, tr, model_cfg, scene, w0, lp, patch, [[s] for s in prog["states"]], nerf.FULL)
        out["detail"][key] = detail(prog, ref)
        return compare(prog, ref)

    def starts(seed, rank_list):
        return [torch.Generator(device=device).manual_seed(sampler_seed(seed, r)).get_state() for r in rank_list]

    if seeds and ranks != 1:
        program, details = mesh_program_readings(cell, seeds, hooks)
        out["program"].update(program)
        out["detail"].update(details)
    for seed in seeds if ranks == 1 else ():
        out["program"][str(seed)] = program_readings(seed, str(seed))
        print("program", seed, out["program"][str(seed)], flush=True)
    scene = common.make_scene(tr, device)
    for name in faults:
        if name == "no_exchange":
            for seed in control_seeds:
                _, w0, lp = common.seeded_weights(model_cfg, tr["views"], seed, device)
                full = reference_check(cell, tr, model_cfg, scene, w0, lp, patch, None, nerf.FULL,
                                       start_states=starts(seed, range(ranks)))
                alone = [reference_check(cell, tr, model_cfg, scene, w0, lp, patch, None, nerf.FULL,
                                         start_states=starts(seed, [r])) for r in range(ranks)]
                readings = compare(alone[0], full)
                readings["rank_gap"] = max(float((a["params"][k] - alone[0]["params"][k]).abs().max())
                                           for a in alone[1:] for k in w0)
                out["faults"][name][str(seed)] = readings
                out["detail"][f"{name}:{seed}"] = detail(alone[0], full)
                print("fault", name, seed, readings, flush=True)
            continue
        undo = FAULTS[name]()
        try:
            for seed in control_seeds:
                out["faults"][name][str(seed)] = program_readings(seed, f"{name}:{seed}")
                print("fault", name, seed, out["faults"][name][str(seed)], flush=True)
        finally:
            undo()
    for seed in control_seeds:
        _, w0, lp = common.seeded_weights(model_cfg, tr["views"], seed, device)
        full = reference_check(cell, tr, model_cfg, scene, w0, lp, patch, None, nerf.FULL,
                               start_states=starts(seed, range(ranks)))
        sides = {"control": nerf.CONTROL, **{k: nerf.CONFIGURED for k in looks if k == "configured_precision"}}
        for name, prec in sides.items():
            other = reference_check(cell, tr, model_cfg, scene, w0, lp, patch, full["states"], prec)
            into = out["control"] if name == "control" else out["looks"][name]
            into[str(seed)] = compare(other, full)
            out["detail"][f"{name}:{seed}"] = detail(other, full)
            print(name, seed, into[str(seed)], flush=True)
    return out


def mesh_program_readings(cell: manifest.Cell, seeds, hooks):
    """Sound runs of a mesh cell in one spawn of its ranks, a short window a
    seed: ({seed: the numbers}, {seed: their detail})."""
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    tr = common.traffic(cell, hooks)
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        mesh_lib.spawn(calibrate_rank_main, (cell.name, [int(v) for v in seeds], tmp, hooks), tr["ranks"],
                       Path(tmp), device_type=common.device_of(hooks).type,
                       join_timeout_s=float(tr["join_timeout_s"]) * len(seeds))
        return json.loads((Path(tmp) / "readings.json").read_text())


def calibrate_rank_main(mesh, cell_name: str, seeds: List[int], out_dir: str, hooks) -> int:
    """One rank of `mesh_program_readings`; rank 0 writes the readings."""
    cell = manifest.find_cell(cell_name, manifest.load_manifest())
    program, details = {}, {}
    for seed in seeds:
        h = types.SimpleNamespace(**(vars(hooks) if hooks is not None else {}))
        h.readings, h.limits = {}, {}
        run_rank(mesh, cell, {"seed": seed, "seconds": 0.0, "trace": 0}, time.time(), h)
        if mesh.is_main:
            details[str(seed)] = h.readings.pop("detail")
            h.readings.pop("losses")
            program[str(seed)] = h.readings
            print("program", seed, program[str(seed)], flush=True)
    if mesh.is_main:
        (Path(out_dir) / "readings.json").write_text(json.dumps([program, details]))
    return 0
