"""The port's spans and counters (`signerf_tpu_torch/utils/tracing.py`) on
the CPU: off without the profiler; under `torch.profiler` nested by parent
and unit, inside the trace's own ranges, self time without the children,
parents kept per thread, the kernels a span launched, the cap; the counters, `factor_grid.table_pack_bytes`
exact from the shapes; the spans a train step and a frame's render open.
"""

import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
from signerf_tpu_torch.engine.train_step import SamplerSettings, make_train_step
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from signerf_tpu_torch.ops import factor_grid, flash_attention
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from signerf_tpu_torch.render import render_cameras
from signerf_tpu_torch.utils import tracing
from signerf_tpu_torch.utils.microbench import span_device_ms
from signerf_tpu_torch.utils.tracing import span

SMALL = dict(max_res=32, hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
             num_nerf_samples_per_ray=4)
VIEWS, H, W = 2, 8, 8


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def records():
    return {r.name: r for r in tracing._records}


def test_nothing_is_recorded_without_the_profiler():
    with span("outer", stream=True):
        with span("inner"):
            torch.ones(4).add(1)
    assert tracing._records == []
    assert tracing.summary() == {"spans": {}, "counters": {}, "units": 0, "dropped": 0}


def test_spans_nest_by_parent_and_unit():
    with cpu_profile():
        for _ in range(2):
            with span("step"):
                with span("a", stream=True):
                    with span("b"):
                        pass
                with span("c"):
                    pass
    by = [(r.name, r.parent, r.unit) for r in tracing._records]
    assert by == [("step", None, 0), ("a", 0, 0), ("b", 1, 0), ("c", 0, 0),
                  ("step", None, 4), ("a", 4, 4), ("b", 5, 4), ("c", 4, 4)]
    s = tracing.summary()
    assert s["units"] == 2 and s["dropped"] == 0
    assert {k: v["count"] for k, v in s["spans"].items()} == {"step": 2, "a": 2, "b": 2, "c": 2}
    assert all(v["stream_ms"] is None for v in s["spans"].values())  # no CUDA events on the CPU


def test_a_span_is_a_range_of_the_trace_around_its_ops():
    with cpu_profile() as prof:
        with span("outer"):
            x = torch.ones(64).add(1)
            with span("inner"):
                x.mul(3)
    events = {e.name: e.time_range for e in prof.events() if e.name in ("outer", "inner", "aten::add", "aten::mul")}
    assert set(events) == {"outer", "inner", "aten::add", "aten::mul"}
    outer, inner = events["outer"], events["inner"]
    for op, around in (("aten::add", outer), ("aten::mul", inner), ("aten::mul", outer)):
        assert around.start <= events[op].start and events[op].end <= around.end
    assert outer.start <= inner.start and inner.end <= outer.end


def test_self_time_leaves_out_the_children():
    with cpu_profile():
        with span("outer"):
            time.sleep(0.02)
            with span("inner"):
                time.sleep(0.03)
    s = tracing.summary()["spans"]
    outer, inner = s["outer"], s["inner"]
    assert outer["host_ms"] >= 50.0 and inner["host_ms"] >= 30.0
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"], abs=1e-9)
    assert 20.0 <= outer["self_host_ms"] < outer["host_ms"] - 25.0


def test_threads_keep_their_own_parents(monkeypatch):
    """The profiler's flag is true on the threads it records (and on
    autograd's backward thread); here both threads are switched on by hand.
    A thread's first span starts a unit of its own, while the other's is
    open."""
    monkeypatch.setattr(tracing, "_profiling", lambda: True)
    opened, b_done = threading.Event(), threading.Event()

    def second():
        opened.wait(10)
        with span("b.outer"):
            with span("b.inner"):
                pass
        b_done.set()

    t = threading.Thread(target=second)
    t.start()
    with span("a.outer"):
        opened.set()
        assert b_done.wait(10)
        with span("a.inner"):
            pass
    t.join(10)
    assert not t.is_alive()
    r = records()
    assert r["a.inner"].parent == r["a.outer"].id and r["b.inner"].parent == r["b.outer"].id
    assert r["b.outer"].parent is None and r["b.outer"].unit == r["b.outer"].id == r["b.inner"].unit
    assert r["a.outer"].unit == r["a.outer"].id == r["a.inner"].unit
    assert r["a.outer"].thread != r["b.outer"].thread == r["b.inner"].thread
    assert tracing.summary()["units"] == 2


def test_a_span_owns_the_kernels_launched_inside_it():
    """`microbench.span_device_ms` on a trace's events: a kernel is each
    span's whose range holds the start of the host op that launched it, on
    any thread; the stream's idle time is in no kernel."""
    from torch.autograd import DeviceType

    def event(name, start, end, kernels=(), thread=1, device=DeviceType.CPU):
        return types.SimpleNamespace(name=name, device_type=device, thread=thread,
                                     time_range=types.SimpleNamespace(start=start, end=end),
                                     kernels=[types.SimpleNamespace(duration=us) for us in kernels])

    events = [
        event("engine.step", 0, 100), event("models.forward", 10, 40), event("engine.backward", 50, 90),
        event("engine.step", 200, 300),
        event("aten::mul", 12, 13, kernels=(500, 250)),  # in models.forward and engine.step
        event("aten::mm", 60, 61, kernels=(2000,), thread=2),  # autograd's thread, inside engine.backward
        event("aten::add", 150, 151, kernels=(7000,)),  # between the steps: no span's
        event("aten::sum", 250, 251, kernels=(1000,)),  # the second step
        event("aten::view", 20, 21),  # launches nothing
        event("density_kernel", 12, 14, device=DeviceType.CUDA),  # the card's own events are not launches
    ]
    got = span_device_ms(events, ["engine.step", "models.forward", "engine.backward", "data.sample"])
    assert got == {"engine.step": 3.75, "models.forward": 0.75, "engine.backward": 2.0, "data.sample": 0.0}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with cpu_profile():
        with span("step"):
            for _ in range(4):
                with span("x"):
                    pass
    s = tracing.summary()
    assert len(tracing._records) == 3 and s["dropped"] == 2
    assert s["spans"]["x"]["count"] == 2 and s["units"] == 1


def test_counters_carry_the_launch_counters(monkeypatch):
    monkeypatch.setattr(ffc, "launches", 7)
    monkeypatch.setattr(ffc, "grad_dot_bwd_table_launches", 5)
    monkeypatch.setattr(flash_attention, "launches", 3)
    c = tracing.counters()
    assert set(c) == {f"fused_factor_cuda.{n}" for n in ffc.COUNTERS} | {
        "flash_attention.launches", "factor_grid.table_pack_bytes", "render.chunks", "render.graph_replays",
        "render.graph_captures"}
    assert c["fused_factor_cuda.launches"] == 7 and c["fused_factor_cuda.grad_dot_bwd_table_launches"] == 5
    assert c["flash_attention.launches"] == 3


def proposal_case(n=33):
    cfg = factor_grid.FactorGridConfig(num_levels=5, base_res=16, max_res=128, features_per_level=8)
    gen = torch.Generator().manual_seed(4)
    lines = [[torch.randn(r, 8, generator=gen) for _ in range(3)] for r in cfg.resolutions]
    ws = [(torch.randn(40, 16, generator=gen), torch.randn(16, generator=gen)),
          (torch.randn(16, 1, generator=gen), torch.randn(1, generator=gen))]
    return cfg, lines, ws, torch.rand(n, 3, generator=gen)


def test_table_pack_bytes_grows_by_the_packed_bytes():
    cfg, lines, ws, x = proposal_case()
    packed = 3 * sum(cfg.resolutions) * cfg.features_per_level * 2  # bf16
    before = factor_grid.table_pack_bytes
    factor_grid.fused_density_mlp(cfg, lines, ws, x)  # outside any unit: the process' count only
    assert factor_grid.table_pack_bytes == before + packed
    with cpu_profile():
        with span("frame"):
            factor_grid.fused_density_mlp(cfg, lines, ws, x)
            factor_grid.fused_density_mlp(cfg, lines, ws, x)
    s = tracing.summary()
    assert factor_grid.table_pack_bytes == before + 3 * packed
    assert s["counters"]["factor_grid.table_pack_bytes"] == 2 * packed
    assert s["counters"]["fused_factor_cuda.launches"] == 0  # the CPU runs the plain twin
    assert s["spans"]["ops.k1"]["count"] == 2 and s["units"] == 1


def tiny_scene():
    model = NerfactoModel(NerfactoModelConfig(**SMALL), num_train_images=VIEWS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    c2w = torch.eye(4)[None, :3, :].repeat(VIEWS, 1, 1)
    c2w[:, 2, 3] = 3.0

    def full(v):
        return torch.full((VIEWS,), float(v))

    cams = Cameras(camera_to_worlds=c2w, fx=full(10), fy=full(10), cx=full(W / 2), cy=full(H / 2), width=W,
                   height=H)
    return model, cams


def test_a_train_step_opens_its_layers_spans():
    model, cams = tiny_scene()
    images = torch.randint(0, 255, (VIEWS, H, W, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    step = make_train_step(model, make_optimizer(OptimizersConfig(), model), cams,
                           SamplerSettings(num_rays=32, micro_batches=2))
    gen = torch.Generator().manual_seed(2)
    step(0, images, None, gen)
    with cpu_profile():
        step(1, images, None, gen)
    parents = {r.name: tracing._records[r.parent].name if r.parent is not None else None for r in tracing._records}
    assert parents == {"engine.step": None, "data.sample": "engine.step", "engine.optimizer": "engine.step",
                       "models.forward": "engine.step", "models.loss": "models.forward",
                       "engine.backward": "engine.step", "ops.k1": "models.forward"}
    counts = {k: v["count"] for k, v in tracing.summary()["spans"].items()}
    assert counts == {"engine.step": 1, "data.sample": 1, "engine.optimizer": 2, "models.forward": 2,
                      "models.loss": 2, "engine.backward": 2, "ops.k1": 6}


def test_a_frame_opens_its_spans_and_packs_its_fields_once_a_chunk():
    model, cams = tiny_scene()
    model.eval()
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3])
    with cpu_profile():
        (frame,) = list(render_cameras(model, cams.slice(slice(0, 1)), aabb, chunk_size=24))
    assert frame["rgb"].shape == (H, W, 3)
    s = tracing.summary()
    chunks = -(-H * W // 24)
    assert {k: v["count"] for k, v in s["spans"].items()} == {
        "render.frame": 1, "render.chunk": chunks, "ops.k1": 3 * chunks, "render.assemble": 1}
    fields = [model.proposal_0.encoding.config, model.proposal_1.encoding.config, model.field.encoding.config]
    per_chunk = sum(3 * sum(c.resolutions) * c.features_per_level * 2 for c in fields)
    assert s["units"] == 1 and s["counters"]["factor_grid.table_pack_bytes"] == chunks * per_chunk
