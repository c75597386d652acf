"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's file is the entry's `file`; the traffic mix is
`benchmark/traffic/<traffic>.json`, whose `driver` names a module
`benchmark/drivers/<driver>.py`; a per-layer metric is read by
`benchmark/metrics/<name>.py`. A later change adds a configuration, a
traffic mix or a metric by adding such files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration file's content
    traffic: Dict
    end_to_end: List[Dict]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict]  # ... and with --trace 1


def load_manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names


def find_cell(name: str, manifest: Dict, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def load_file_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver_module(cell: Cell) -> ModuleType:
    """`drivers.<driver>`, imported by name, so that ranks it spawns can
    import its functions (`benchmark/` is on the path)."""
    return importlib.import_module(f"drivers.{cell.traffic['driver']}")


def metric_reader(metric_name: str) -> ModuleType:
    safe = metric_name.replace(".", "_").replace("-", "_")
    return load_file_module(BENCH_DIR / "metrics" / f"{metric_name}.py", f"bench_metric_{safe}")
