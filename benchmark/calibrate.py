"""Read what the limits of a cell's comparison are set from, in one process:
the program against the plain reference on many seeds, the control (the
reference in the precision below the configuration's) and the planted
faults on a few, at the cell's own sizes and without a window.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 7,8,9 \
        [--faults half_batch] [--looks configured_precision] --out FILE.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None, hooks=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--looks", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    for path in (BENCH_DIR.parent, BENCH_DIR):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import run

    run.set_caches()
    from harness import manifest

    cell = manifest.find_cell(args.workload, manifest.load_manifest())
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    words = lambda s: [v for v in s.split(",") if v]  # noqa: E731
    looks = {"looks": words(args.looks)} if args.looks else {}
    result = manifest.driver_module(cell).calibrate(cell, ints(args.seeds), ints(args.control_seeds),
                                                    words(args.faults), hooks, **looks)
    result["workload"] = args.workload
    if hooks is None:
        import torch

        result["device"] = torch.cuda.get_device_name(0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
