"""`chunk_graph_share.render`: the share of a traced frame's chunks that
replayed a CUDA graph, from the program's counters. On the CPU the render
stays eager, so a traced run reads 0 (on the card every chunk after the
first frame's first replays: 100); a program without the counters reads
None."""

from __future__ import annotations

import json
import sys
import types

from bench_helpers import TINY_RENDER, hooks

NAME = "chunk_graph_share.render"


def test_manifest_names_the_share_for_the_render_cell_only():
    from harness import manifest

    (m,) = [m for m in manifest.load_manifest()["per_layer"] if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "models: host", "render_rays_per_s", ["signerf_nerfacto.render"])


def test_a_traced_cpu_render_reads_no_replays(capsys):
    import run
    from signerf_tpu_torch.utils import tracing

    tracing.reset()
    assert run.main(["--workload", "signerf_nerfacto.render", "--seed", "3000000029", "--seconds", "1",
                     "--trace", "1"], hooks=hooks(traffic=dict(TINY_RENDER, trace_frames=2))) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}


def test_the_share_is_replays_over_chunks(monkeypatch):
    from harness import manifest
    from signerf_tpu_torch.utils import tracing

    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(units=4))
    counts = {"render.chunks": 128, "render.graph_replays": 96}
    monkeypatch.setattr(tracing, "summary", lambda: {"counters": counts})
    assert manifest.metric_reader(NAME).read(ctx) == 75.0
    counts.pop("render.graph_replays")
    assert manifest.metric_reader(NAME).read(ctx) == 0.0
    counts.pop("render.chunks")  # the parent's counters: no render counters at all
    assert manifest.metric_reader(NAME).read(ctx) is None
    monkeypatch.setitem(sys.modules, "signerf_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["signerf_tpu_torch.utils"], "tracing", raising=False)
    assert manifest.metric_reader(NAME).read(ctx) is None
