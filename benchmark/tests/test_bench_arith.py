"""The yardstick's frozen arithmetic on hand-made inputs, the result line's
schema, and the check for JAX by whole top-level module names."""

from __future__ import annotations

import json
import sys
import types

import pytest

from bench_helpers import BENCH_DIR, ROOT  # noqa: F401


def test_bound_is_the_larger_of_bytes_and_operations():
    from harness import peaks

    assert peaks.bound_ms(3.35e9) == pytest.approx(1.0)
    assert peaks.bound_ms(0.0, bf16_flops=989e9) == pytest.approx(1.0)
    assert peaks.bound_ms(0.0, f32_flops=67e9) == pytest.approx(1.0)
    assert peaks.bound_ms(3.35e9, bf16_flops=2 * 989e9) == pytest.approx(2.0)


def test_factor_bounds_by_hand():
    from harness import peaks

    b = peaks.factor_bounds([16, 32], feat=8, n=1000)
    d = 2 * 8
    tables = 3 * 8 * (16 + 32)
    want_bytes = 12 * 1000 + 2 * tables + 4 * 1000 * d
    want_ops = 11 * d * 1000
    assert b["encode"] == pytest.approx(max(want_bytes / 3.35e12, want_ops / 67e12) * 1e3)


def test_roofline_share_of_a_reader():
    """factor_roofline: the bound over the factor kernels' device time."""
    from harness import manifest
    from harness.trace import TraceSummary

    trace = TraceSummary(units=2, window_s=1.0, busy_s=0.5, kernels_s={"density_kernel": 0.004,
                                                                        "encode_kernel": 0.004, "elementwise": 0.2},
                         groups_s={"K1": 0.004, "K3": 0.004, "other": 0.2}, idle_gaps=[])
    ctx = types.SimpleNamespace(trace=trace, extra={"factor_bound_ms_per_unit": 1.0}, unit_wall_s=0.1,
                                memory_peak_bytes=2**31)
    share = manifest.metric_reader("factor_roofline.train").read(ctx)
    assert share == pytest.approx(100.0 * 1.0 / 4.0)  # 8 ms over 2 steps: 4 ms a step
    assert manifest.metric_reader("eager_device_ms.train").read(ctx) == pytest.approx(100.0)
    assert manifest.metric_reader("device_idle.train").read(ctx) == pytest.approx(50.0)
    assert manifest.metric_reader("peak_mem_gib.train").read(ctx) == pytest.approx(2.0)


def test_mfu_by_hand():
    from harness import flops, manifest

    per = flops.PerRay(tc=989, f32=67)
    assert per.seconds_at_peak(1e9, False, 989e12, 67e12) == pytest.approx(2e-3)
    assert per.seconds_at_peak(1e9, True, 989e12, 67e12) == pytest.approx(6e-3)
    ctx = types.SimpleNamespace(extra={"peak_s_per_unit": 6e-3}, unit_wall_s=0.06, trace=None)
    assert manifest.metric_reader("train_mfu.train").read(ctx) == pytest.approx(10.0)
    ctx = types.SimpleNamespace(extra={"peak_s_per_unit": 6e-3}, unit_wall_s=float("nan"), trace=None)
    assert manifest.metric_reader("render_mfu.render").read(ctx) is None


def test_nerfacto_flops_by_hand():
    from harness import flops

    model = json.loads((BENCH_DIR / "configs" / "signerf_nerfacto.json").read_text())["model"]
    per = flops.nerfacto_per_ray(model)
    base_in_kernel = 2 * (128 * 64 + 64 * 16)
    prop_mlp = 2 * (40 * 16 + 16 * 1)
    assert per.tc == 48 * base_in_kernel + 256 * prop_mlp + 96 * prop_mlp
    enc = 8 * 16 * 11
    heads = 2 * (63 * 64 + 64 * 64 + 64 * 3)
    assert per.f32 == 48 * (enc + heads) + (256 + 96) * (5 * 8 * 11)


def test_whole_window_rates_and_the_tail():
    from harness.stats import percentile

    times = [0.1] * 190 + [0.2] * 10  # 200 frames: ten lie beyond the 95th percentile
    p95 = percentile(times, 95.0)
    assert p95 == 0.1 and sum(t > p95 for t in times) == 10
    assert percentile(list(range(1, 201)), 95.0) == 190
    rays_per_frame, window_s = 512 * 512, 40.0
    assert len(times) * rays_per_frame / window_s == pytest.approx(1310720.0)


def test_kernel_groups():
    from harness import peaks

    assert peaks.group_of("void density_kernel<8, 16>(float const*)") == "K1"
    assert peaks.group_of("density_bwd_tables_kernel") == "K2"
    assert peaks.group_of("encode_bwd_dot_kernel<256>") == "K4"
    assert peaks.group_of("grad_dot_bwd_tables_kernel") == "K6"
    assert peaks.group_of("flash_attention_kernel") == "K7"
    assert peaks.group_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "nccl"
    assert peaks.group_of("sm90_xmma_fprop_implicit_gemm_f32f32") == "conv"
    assert peaks.group_of("nvjet_tst_64x8_64x16_4x1_v_bz_TNT") == "gemm"
    assert peaks.group_of("void at::native::vectorized_elementwise_kernel<4>") == "other"


def test_no_jax_by_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "signerf_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax_like_name", types.ModuleType("x"))
    assert "signerf_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "signerf_tpu.ops", types.ModuleType("signerf_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == sorted({"signerf_tpu", "jaxlib"} | ({"jax"} if "jax" in sys.modules else set())
                                             | ({"flax"} if "flax" in sys.modules else set()))


def test_result_line_schema():
    from harness import manifest, report
    from harness.trace import TraceSummary

    cell = manifest.find_cell("signerf.refine", manifest.load_manifest())
    trace = TraceSummary(units=4, window_s=0.4, busy_s=0.3, kernels_s={"density_kernel": 0.01, "x": 0.29},
                         groups_s={"K1": 0.01, "other": 0.29}, idle_gaps=[("aten::item", 0.05)])
    layer = report.LayerContext(cell=cell.name, config=cell.config, traffic=cell.traffic, trace=trace,
                                unit_wall_s=0.07, memory_peak_bytes=2**33,
                                extra={"peak_s_per_unit": 1e-3, "factor_bound_ms_per_unit": 0.5})
    out = report.Outcome(end_to_end={"train_rays_per_s": 2.5e5, "setup_s": 20.0},
                         checks=[("loss_gap", 1e-4, 1e-3), ("grad_gap", 0.5, 0.1)], attempted=400, failed=0,
                         memory_peak_bytes=2**33, device_kind="NVIDIA H100 80GB HBM3", device_count=1, layer=layer)
    for trace_flag in (0, 1):
        line = report.result_line(cell, types.SimpleNamespace(trace=trace_flag), out)
        assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
        assert line["correct"] is False  # grad_gap over its limit
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        json.dumps(line)
        if trace_flag:
            assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
            assert line["device"]["busy_s"] == 0.3 and line["device"]["window_s"] == 0.4
            assert len(line["breakdown"]["device_ops"]) <= 10
        else:
            assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
            assert line["metrics"]["setup_s"] == {"value": 20.0, "unit": "s"}
