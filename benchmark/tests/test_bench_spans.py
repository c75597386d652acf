"""The per-layer metrics read from the program's spans and counters: a
traced run of each one-card cell on the CPU reports its host metrics (the
stream ones need CUDA events), `table_pack_mb.render` equal to the count
from the shapes; a program without spans reports none of them."""

from __future__ import annotations

import json
import sys
import types

from bench_helpers import TINY_RENDER, TINY_TRAIN, hooks

SPAN_METRICS = {"data_stream_ms.train", "forward_stream_ms.train", "backward_stream_ms.train",
                "optimizer_stream_ms.train", "dispatch_ms.train", "dispatch_ms.render", "k1_host_ms.render",
                "table_pack_mb.render"}


def traced_line(workload: str, traffic: dict, capsys) -> dict:
    import run
    from signerf_tpu_torch.utils import tracing

    tracing.reset()  # one run a process in the benchmark; here the tests share one
    assert run.main(["--workload", workload, "--seed", "3000000027", "--seconds", "1", "--trace", "1"],
                    hooks=hooks(traffic=traffic)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def packed_mb_a_chunk(model: dict) -> float:
    """Bytes of bf16 line tables each field packs for one chunk, in MB."""
    from harness.flops import resolutions

    f = model["field"]
    sizes = [(resolutions(f["factor_num_levels"], model["base_res"], model["max_res"]),
              f["factor_features_per_level"])]
    sizes += [(resolutions(a["num_levels"], model["proposal_base_res"], a["max_res"]),
               model["proposal_factor_features_per_level"]) for a in model["proposal_net_args_list"]]
    return sum(3 * sum(res) * feat * 2 for res, feat in sizes) / 1e6


def test_manifest_names_the_span_metrics_for_one_card_cells_only():
    from harness import manifest

    bench = manifest.load_manifest()
    added = {m["name"]: m for m in bench["per_layer"] if m["name"] in SPAN_METRICS}
    assert set(added) == SPAN_METRICS
    for name, m in added.items():
        assert m["source"] == ("program_counter" if name == "table_pack_mb.render" else "program_span")
        assert m["workloads"] == (["signerf.refine"] if name.endswith(".train") else ["signerf_nerfacto.render"])


def test_refine_traced_run_reports_the_step_spans(capsys):
    line = traced_line("signerf.refine", dict(TINY_TRAIN, trace_steps=2), capsys)
    got = set(line["metrics"]) & SPAN_METRICS
    assert got == {"dispatch_ms.train"}  # the CPU records no CUDA events
    assert line["metrics"]["dispatch_ms.train"]["value"] > 0


def test_render_traced_run_reports_the_frame_spans_and_the_packed_tables(capsys):
    from harness import manifest

    tiny = dict(TINY_RENDER, trace_frames=2)
    line = traced_line("signerf_nerfacto.render", tiny, capsys)
    assert set(line["metrics"]) & SPAN_METRICS == {"dispatch_ms.render", "k1_host_ms.render", "table_pack_mb.render"}
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < metrics["k1_host_ms.render"] <= metrics["dispatch_ms.render"]
    model = manifest.find_cell("signerf_nerfacto.render", manifest.load_manifest()).config["model"]
    chunks = -(-tiny["frame_size"] ** 2 // tiny["chunk_size"])
    assert abs(metrics["table_pack_mb.render"] - chunks * packed_mb_a_chunk(model)) <= 1e-12


def test_a_program_without_spans_reports_none(monkeypatch):
    import signerf_tpu_torch.utils
    from harness import manifest

    monkeypatch.delattr(signerf_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "signerf_tpu_torch.utils.tracing", None)  # its import raises ImportError
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(units=4))
    for name in sorted(SPAN_METRICS):
        assert manifest.metric_reader(name).read(ctx) is None
