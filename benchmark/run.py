"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration and a traffic
mix; the traffic mix names the driver that builds the program's objects
from the seed, warms them up, measures for `--seconds` and checks what the
timed path produced against the plain reference. With `--trace 0` the
result carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from a profiled part of the window.

The run exits without a result when torch sees no CUDA device or fewer
than the cell asks for, and when JAX, flax or the JAX package is loaded,
once the window has closed, in this process or in any rank it spawned.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from harness.guard import forbidden_modules  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds go to build/kernels/ there already), and one
    host thread for PyTorch's CPU operators: the cells' host work is the
    launching thread's, and idle pool threads that spin take cores from it."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None, hooks=None) -> int:
    """`hooks` (tests only): a driver's test settings, which skip the look
    for a card and plant faults; the run is otherwise the same."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    for path in (ROOT, BENCH_DIR):  # the program's package, then the benchmark's own
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    set_caches()
    from harness import manifest, report

    cell = manifest.find_cell(args.workload, manifest.load_manifest())
    import torch

    if hooks is None and not report.devices_ok(torch, cell.chips):
        return 3
    outcome = manifest.driver_module(cell).run(cell, args, T0, hooks)
    found = {"this process": forbidden_modules()}
    found.update({f"rank {r}": names for r, names in sorted(outcome.rank_modules.items())})
    found = {where: names for where, names in found.items() if names}
    if found:
        print(f"refused: after the window {found}", file=sys.stderr, flush=True)
        return 4
    line = report.result_line(cell, args, outcome)
    report.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
