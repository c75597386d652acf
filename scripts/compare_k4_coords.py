"""Times K4's coords half (and K5) of other builds of the port's kernel
sources against this tree's, on one NVIDIA card, in turns.

    python3 scripts/compare_k4_coords.py [--build NAME=CSRC_DIR ...] [--zeroed NAME ...]
        [--out DIR]

Each `--build` names a directory of kernel sources laid out as
`signerf_tpu_torch/csrc` (another commit's, unpacked with `git archive
<commit> signerf_tpu_torch/csrc | tar -x -C DIR`, or a copy with a variant
of a kernel). Its `fused_factor_encode.cu` and `fused_factor_grad_dot.cu`
are compiled with this tree's nvcc flags into libraries of their own, which
stand in for this tree's while their turn runs, so the wrappers of
`fused_factor_cuda.py` call them unchanged. A build named by `--zeroed` is
one whose K4 coords half adds into its output (before that half wrote
every row): it is called as its own wrapper called it, into a zeroed
g_coords, and its time holds that memset.

Cases: the base field (8 levels, F = 16) at one `signerf` micro-batch
(N = 196,608) and the proposal schedule (5 levels, F = 8, max_res 128) at a
render chunk's samples (N = 2,097,152), each at three layouts of the
samples (uniform, ray-ordered, one cell). For every build: K4's coords
half's norm-relative error against its plain twin and, at the base field,
whether it equals K5 bit for bit and whether K5 equals this tree's; then CUDA-event means of 50 calls in
turns (the builds, this tree, this tree, the builds in reverse), beside the
byte bound of `chip_smoke.factor_bounds` and the share of it. The card's
name and power limit come first, one JSON line of every number last (also
written to OUT/compare_k4_coords.json, OUT defaulting to build/compare/).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NAMES = ("fused_factor_encode", "fused_factor_grad_dot")
ITERS = 50


def build(csrc: Path, out: Path, cb) -> tuple:
    """Compile `csrc`'s two libraries into `out` at once -> ({name: CDLL}, ptxas log)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        so = out / f"{name}.so"
        cmd = [cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, []
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cb.ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs, "".join(logs)


def ptxas_lines(log: str) -> list:
    """The tile loop's and the coords kernels' registers and spills."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(k in ln for k in ("dot", "encode_bwd")):
            rest = [x.strip().removeprefix("ptxas info    : ") for x in lines[i + 1 : i + 4]
                    if "registers" in x or "spill" in x]
            out.append(f"{ln.split(chr(39))[1]}: " + "; ".join(rest))
    return out


def case(torch, cs, schedule: str, layout: str, gen, dev):
    """(args, g, N) of one case on the card."""
    if schedule == "base":
        n = cs.SIGNERF_SAMPLES
        args, g, _ = cs.encode_case(torch, n, gen, dev, layout)
        return args, g, n
    n = cs.PROPOSAL_SAMPLES
    res, feat, tables, *_, x = cs.make_case(torch, 5, 128, 8, 16, 1, n, gen, dev)
    if layout == "ray-ordered":
        x = cs.ray_ordered_coords(torch, 256, gen, n // 256).to(dev)
    elif layout == "one cell":
        x = cs.one_cell_coords(torch, n, gen).to(dev)
    return (res, feat, tables, x), torch.randn(n, 5 * feat, generator=gen).to(dev), n


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--build", action="append", default=[], metavar="NAME=CSRC_DIR")
    parser.add_argument("--zeroed", action="append", default=[], metavar="NAME")
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "compare")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from signerf_tpu_torch.ops import cuda_build as cb
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    builds = {"this": {name: cb.library(name) for name in NAMES}}
    logs = {"this": cb.build_log}
    for spec in opts.build:
        name, _, path = spec.partition("=")
        builds[name], logs[name] = build(Path(path).resolve(), ROOT / "build" / "compare" / name, cb)
    for name, log in logs.items():
        for ln in ptxas_lines(log):
            print(f"ptxas {name}: {ln}", flush=True)
    others = [b for b in builds if b != "this"]
    turns = others + ["this", "this"] + others[::-1]

    def use(name: str) -> None:
        cb._libs.update(builds[name])

    def k4_coords(args, g, zeroed: bool):
        if not zeroed:
            return ffc.encode_bwd_cuda(*args, g, False, True)[1]
        res, feat, tables, x = args
        out = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=x.device)
        ffc._launch("fused_factor_encode", "fused_factor_encode_backward", x.device, x.data_ptr(), g.data_ptr(),
                    x.shape[0], tables.data_ptr(), (ctypes.c_int * len(res))(*res), len(res), feat, None,
                    out.data_ptr(), 1)
        return out

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    results = []
    for schedule in ("base", "proposal"):
        for layout in cs.LAYOUTS:
            args, g, n = case(torch, cs, schedule, layout, gen, dev)
            want = ffc.encode_bwd_plain(*args, g, False, True)[1]
            b_ms, b_by = cs.factor_bounds(args[0], args[1], args[2], n)["K4 coords"]
            row = {"schedule": schedule, "layout": layout, "n": n, "bound_ms": b_ms, "bound_by": b_by}
            k4 = {name: (lambda z=name in opts.zeroed: k4_coords(args, g, z)) for name in builds}
            k5 = lambda: ffc.grad_dot_cuda(*args, g)  # noqa: E731
            use("this")
            s5 = k5() if schedule == "base" else None
            for name in builds:
                use(name)
                got = k4[name]()
                torch.cuda.synchronize()
                row[f"err {name}"] = cs.rel_err(got, want)
                row[f"finite {name}"] = bool(torch.isfinite(got).all())
                if schedule == "base":
                    row[f"K4 == K5 {name}"] = bool(torch.equal(got, k5()))
                    row[f"K5 same bits {name}"] = bool(torch.equal(k5(), s5))  # as this tree's K5
            times = {}
            for name in turns:
                use(name)
                times.setdefault(f"K4 {name}", []).append(cs.cuda_ms(k4[name], ITERS))
                if schedule == "base":
                    times.setdefault(f"K5 {name}", []).append(cs.cuda_ms(k5, ITERS))
            for key, v in times.items():
                row[key] = sum(v) / len(v)
                row[key + " turns"] = v
            results.append(row)
            msg = f"{schedule} {layout} N={n}: K4 coords ms (bound {b_ms:.4f} {b_by}):"
            for name in builds:
                msg += (f" {name} {row[f'K4 {name}']:.4f} ({b_ms / row[f'K4 {name}']:.1%}, err "
                        f"{row[f'err {name}']:.2e}{', == K5' if row.get(f'K4 == K5 {name}') else ''});")
            if schedule == "base":
                msg += " K5 ms: " + ", ".join(
                    f"{name} {row[f'K5 {name}']:.4f}{'' if row[f'K5 same bits {name}'] else ' (other bits)'}"
                    for name in builds)
            print(msg, flush=True)
            del args, g, want, s5
            torch.cuda.empty_cache()
    use("this")
    line = json.dumps({"card": card, "results": results})
    opts.out.mkdir(parents=True, exist_ok=True)
    (opts.out / "compare_k4_coords.json").write_text(line + "\n")
    print(line)
    ok = all(v for r in results for k, v in r.items() if k.startswith("finite"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
