"""Time the tensor-parallel SDXL sheet inpaint against one card.

Smoke phase 16's call, `Diffuser.diffuse` at the defaults (20 steps,
strength 0.9: 18 sampler steps, sequential CFG) on a 3x3 sheet of 512 px
cells (1536 px; seeded random pixels, a disc of mask in each cell, a
seeded depth), SDXL + ControlNet-depth at the published widths and seeded
random bf16 weights, in turns: one card, a tensor group of T cards, the
group again, one card again. Each turn is one timed inpaint after a warm
one. For each: the sampler step's median and range from the pipeline's
own CUDA events, the wall, and the peak memory of each card; for the group
also one sampler step's model work (both CFG branches) under
`torch.profiler`, its device time by kernel group (the all-reduces, K7,
the rest) and its idle share; then K7 alone at the sheet's shapes (S =
9216 and 2304) with the heads a card runs (10 and 20 on one card, 10 / T
and 20 / T in the group), beside `scaled_dot_product_attention` and the
bound. The group's ranks are one process a card over NCCL, on cards 0 to
T - 1 (T = 2). Usage, from the repository root, on a host of two or more
cards:

    python scripts/measure_tp_sheet_torch.py [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig  # noqa: E402
from signerf_tpu_torch.ops import flash_attention as fa  # noqa: E402
from signerf_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from signerf_tpu_torch.utils.microbench import card_name, cuda_ms, kernel_breakdown, require_cuda  # noqa: E402

SHEET, CELL = 1536, 512
GROUPS = [("all-reduce", ("allreduce", "all_reduce", "nccl")), ("K7", ("flash_attention_kernel",))]
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # the H100 SXM's published peaks at 700 W
TENSOR = 2


def sheet_inputs(seed: int = 0):
    """(image, mask, depth) of the sheet: [1536, 1536, 3 | 1 | 1] float32."""
    rng = np.random.default_rng(seed)
    image = rng.random((SHEET, SHEET, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(SHEET) % CELL, np.arange(SHEET) % CELL, indexing="ij")
    mask = (((yy - CELL / 2) ** 2 + (xx - CELL / 2) ** 2) < (CELL / 4) ** 2).astype(np.float32)[..., None]
    depth = np.clip(rng.random((SHEET // 64, SHEET // 64), np.float32).repeat(64, 0).repeat(64, 1), 0, 1)[..., None]
    return image, mask, depth


def inpaint(diffuser: Diffuser, inputs) -> dict:
    """One timed `diffuse` of the sheet: wall, sampler-step median and range
    (the pipeline's CUDA events), K7 launches, peak memory."""
    dev = diffuser.pipeline.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    t0 = time.perf_counter()
    out = diffuser.diffuse(inputs[0], inputs[0], inputs[1], inputs[2])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ev = diffuser.pipeline.last_run["step_events"]
    ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1))
    if not np.isfinite(out).all():
        raise RuntimeError("the inpaint is not finite")
    return {"wall_s": wall, "step_median_ms": ms[len(ms) // 2], "step_range_ms": [ms[0], ms[-1]], "steps": len(ms),
            "k7_launches": fa.launches, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "sequential_cfg": diffuser.pipeline.last_run["sequential_cfg"]}


def branch_fn(pipe, inputs):
    """Both CFG branches of one sampler step's model work at the sheet shape."""
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(1, SHEET // 8, SHEET // 8, 4, generator=g, device=dev) * 0.2
    cond = torch.as_tensor(inputs[2], device=dev).repeat_interleave(3, -1)[None]
    t = torch.full((1,), 500.0, device=dev)
    ctx, pooled = pipe.encode_prompt(DiffuserConfig().prompt, "")
    tids = torch.tensor([[SHEET, SHEET, 0, 0, SHEET, SHEET]], dtype=torch.float32, device=dev)
    scale = torch.tensor(0.8, device=dev)

    def step():
        with torch.no_grad():
            for b in (0, 1):
                c, p = ctx[b : b + 1], pooled[b : b + 1]
                down, mid = pipe.controlnet(x, cond, t, c, p, tids)
                pipe.unet(x, t, c, p, tids, [r.float() * scale for r in down], mid.float() * scale)

    return step


def k7_calls(heads_10: int, heads_20: int, dev) -> dict:
    """K7 alone at the sheet's two shapes with these head counts: kernel and
    SDPA ms a call (CUDA events, 20 calls after a warm-up) and the bound."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for s, h in ((9216, heads_10), (2304, heads_20)):
        q, k, v = (torch.randn(1, s, h, 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        kernel = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, 0.125), 20)
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=0.125), 20)
        bound = max(4 * s * h * 64 * 2 / HBM_BYTES_PER_S, 4 * h * s * s * 64 / BF16_FLOPS) * 1e3
        out[f"(1, {s}, {h})"] = {"kernel_ms": kernel, "sdpa_ms": sdpa, "bound_ms": bound}
    return out


def tp_rank(mesh, inputs_path: str, out: str) -> int:
    """A rank of the group: the sharded stack, two turns (each a warm and a
    timed inpaint), a profiled step, K7 at its heads; to `out`/rank{r}.json."""
    data = np.load(inputs_path)
    inputs = (data["image"], data["mask"], data["depth"])
    diffuser = Diffuser(DiffuserConfig(), device=mesh.device, mesh=mesh)
    pipe = diffuser.pipeline
    rec = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend, "init_s": pipe.init_seconds,
           "sharded_gb": sum(t.numel() * t.element_size() for t in pipe.tensors(sharded=True)) / 1e9,
           "whole_gb": sum(t.numel() * t.element_size() for t in pipe.tensors(sharded=False)) / 1e9, "turns": []}
    for _ in range(2):
        diffuser.diffuse(inputs[0], *inputs)  # warm
        mesh.barrier()
        rec["turns"].append(inpaint(diffuser, inputs))
        mesh.barrier()
    bd = kernel_breakdown(branch_fn(pipe, inputs), GROUPS)
    rec["profile"] = {k: bd[k] for k in ("span_ms", "groups_ms", "busy_ms", "idle_share")}
    rec["k7"] = k7_calls(10 // mesh.tensor, 20 // mesh.tensor, mesh.device)
    Path(out, f"rank{mesh.rank}.json").write_text(json.dumps(rec))
    return 0


def one_card_turn(diffuser: Diffuser, inputs) -> dict:
    diffuser.diffuse(inputs[0], *inputs)  # warm
    return inpaint(diffuser, inputs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    require_cuda()
    if torch.cuda.device_count() < TENSOR:
        raise RuntimeError(f"a tensor group of {TENSOR} needs {TENSOR} cards, one a rank (NCCL); "
                           f"{torch.cuda.device_count()} visible")
    card = card_name()
    dev = torch.device("cuda", 0)
    inputs = sheet_inputs()
    result = {"script": "scripts/measure_tp_sheet_torch.py", "date": time.strftime("%Y-%m-%d"), "hardware": card,
              "cards": torch.cuda.device_count(), "tensor": TENSOR, "backend": "nccl",
              "torch": torch.__version__, "cuda": torch.version.cuda}
    one = Diffuser(DiffuserConfig(), device=dev)
    result["one_card"] = {"turns": [one_card_turn(one, inputs)]}
    result["one_card"]["k7"] = k7_calls(10, 20, dev)
    bd = kernel_breakdown(branch_fn(one.pipeline, inputs), GROUPS)
    result["one_card"]["profile"] = {k: bd[k] for k in ("span_ms", "groups_ms", "busy_ms", "idle_share")}
    print(f"one card, turn 1: {result['one_card']['turns'][0]}", flush=True)
    with tempfile.TemporaryDirectory(prefix="tp_sheet_") as tmp:
        np.savez(Path(tmp) / "inputs.npz", image=inputs[0], mask=inputs[1], depth=inputs[2])
        t0 = time.perf_counter()
        mesh_lib.spawn(tp_rank, (str(Path(tmp) / "inputs.npz"), tmp), TENSOR, Path(tmp), device_type="cuda",
                       backend="nccl", cards=TENSOR, join_timeout_s=1200.0, tensor=TENSOR)
        result["group_wall_s"] = time.perf_counter() - t0
        result["group"] = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(TENSOR)]
    result["one_card"]["turns"].append(one_card_turn(one, inputs))
    for rank in result["group"]:
        print(f"group rank {rank['rank']} on {rank['device']} ({rank['backend']}): turns {rank['turns']}; profile "
              f"{rank['profile']}; K7 {rank['k7']}", flush=True)
    print(f"one card, turn 2: {result['one_card']['turns'][1]}; profile {result['one_card']['profile']}; K7 "
          f"{result['one_card']['k7']}; on {card}", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=2))
        print(f"wrote {args.json}", flush=True)
    return result


if __name__ == "__main__":
    main()
