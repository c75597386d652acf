"""What a run reports: the outcome a driver hands back, the per-layer
readers' context, and the result line."""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional, Tuple

from harness import manifest
from harness.trace import TraceSummary


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads. `units` are the cell's units of work
    (steps, frames, views); every per-unit number is over the traced ones."""

    cell: str
    config: Dict
    traffic: Dict
    trace: TraceSummary
    unit_wall_s: float  # a unit's wall time in the untraced part of the window
    memory_peak_bytes: int
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    checks: List[Tuple[str, float, float]]  # (name, value, limit): value <= limit passes
    attempted: int
    failed: int
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    layer: Optional[LayerContext] = None
    # a spawned rank's forbidden top-level modules after the window (`harness.guard`)
    rank_modules: Dict[int, List[str]] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            math.isfinite(v) and v <= limit for _, v, limit in self.checks)


def devices_ok(torch, chips: int) -> bool:
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card only", file=sys.stderr)
        return False
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return False
    return True


def print_checks(checks) -> None:
    for name, value, limit in checks:
        verdict = "ok" if math.isfinite(value) and value <= limit else "FAILED"
        print(f"check {name}: {value!r} (limit {limit!r}) {verdict}", file=sys.stderr, flush=True)


def result_line(cell: manifest.Cell, args, outcome: Outcome) -> Dict:
    metrics: Dict[str, Dict] = {}
    device = {"platform": "gpu", "kind": outcome.device_kind, "count": outcome.device_count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed}
    if args.trace:
        ctx = outcome.layer
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        line["metrics"] = metrics
        line["device"] = device
        line["breakdown"] = {"device_ops": [[n, s] for n, s in ctx.trace.device_ops()],
                             "idle_gaps": [[n, s] for n, s in ctx.trace.idle_gaps]}
    else:
        for m in cell.end_to_end:
            if m["name"] in outcome.end_to_end:
                metrics[m["name"]] = {"value": float(outcome.end_to_end[m["name"]]), "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = device
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in outcome.checks}
    return line
