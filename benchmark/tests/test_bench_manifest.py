"""BENCHMARK.json parses, keeps the benchmark's contract, and names files
that exist; a configuration, a traffic mix and a per-layer metric added as
new files and entries alone are found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_helpers import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in bench["end_to_end"] + bench["per_layer"])) == len(
        bench["end_to_end"] + bench["per_layer"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_cells_and_configs(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = bench["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert w["chips"] in (1, 4) and w["config"] in configs and len(w["why"]) <= 200
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
        reported = [m["name"] for m in bench["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in bench["per_layer"])
    for c in configs.values():
        file = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and all(k in file for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells)


def test_new_files_are_found_by_name(tmp_path, bench):
    """A later change adds a configuration, a traffic mix and a metric by
    new files and entries alone: the harness finds all three by name."""
    from harness import manifest

    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "configs" / "signerf_small.json").write_text(
        (BENCH_DIR / "configs" / "signerf.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / "refine.json").read_text())
    traffic["micro_batches"] = 4
    (root / "benchmark" / "traffic" / "refine.micro4.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.units)\n")
    added = dict(bench)
    added["configs"] = bench["configs"] + [dict(bench["configs"][0], name="signerf_small",
                                                file="benchmark/configs/signerf_small.json")]
    added["workloads"] = bench["workloads"] + [dict(name="signerf_small.refine.micro4", config="signerf_small",
                                                    traffic="refine.micro4", chips=1, why="added")]
    added["per_layer"] = bench["per_layer"] + [dict(name="steps_seen.train", unit="steps", better="higher",
                                                    source="device_trace", layer="engine",
                                                    moves="train_rays_per_s",
                                                    workloads=["signerf_small.refine.micro4"])]
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    cell = manifest.find_cell("signerf_small.refine.micro4", manifest.load_manifest(root), root)
    assert cell.traffic["micro_batches"] == 4 and cell.config["name"] == "signerf"
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.train"]
    reader = manifest.load_file_module(root / "benchmark" / "metrics" / "steps_seen.train.py", "steps_seen")
    assert reader.read(type("Ctx", (), {"trace": type("T", (), {"units": 3})})()) == 3.0
