"""The comparison that decides `correct` fails what it must: the control
(the reference in the precision below the configuration's) and runs with
the timed path broken underneath (a step that leaves the state unchanged,
half the batch left out, one level of the base field's tables left without
its gradient, the exchange between ranks left out, an answer altered where
it is produced). Each run skips the harness's look for a
card and is otherwise a whole run at a tiny size on the CPU, held to the
cells' own limits."""

from __future__ import annotations

import json

import pytest

from bench_helpers import TINY_RENDER, TINY_TRAIN, hooks


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_cell(workload: str, h, trace: int = 0) -> int:
    import run

    return run.main(["--workload", workload, "--seed", "3000000019", "--seconds", "1", "--trace", str(trace)],
                    hooks=h)


def limits(cell: str) -> dict:
    from harness import manifest

    return json.loads((manifest.BENCH_DIR / "limits" / f"{cell}.json").read_text())["limits"]


def fails(readings: dict, cell: str) -> bool:
    lim = limits(cell)
    return any(readings[k] > lim[k] for k in readings if k in lim)


def test_refine_control_fails():
    import calibrate

    h = hooks(traffic=dict(TINY_TRAIN))
    from harness import manifest

    cell = manifest.find_cell("signerf.refine", manifest.load_manifest())
    out = manifest.driver_module(cell).calibrate(cell, [], [3000000021], [], h)
    assert fails(out["control"]["3000000021"], "signerf.refine"), out
    assert calibrate  # the entry that runs this at the cell's size on the card


def test_render_control_fails():
    from harness import manifest

    cell = manifest.find_cell("signerf_nerfacto.render", manifest.load_manifest())
    out = manifest.driver_module(cell).calibrate(cell, [], [3000000023], [], hooks(traffic=dict(TINY_RENDER)))
    assert fails(out["control"]["3000000023"], "signerf_nerfacto.render"), out


def test_render_sound_run_is_correct(capsys):
    assert run_cell("signerf_nerfacto.render", hooks(traffic=dict(TINY_RENDER))) == 0
    line = last_line(capsys)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"render_rays_per_s", "frame_p95_ms", "setup_s"}


def test_render_altered_answer_is_caught(capsys, monkeypatch):
    from signerf_tpu_torch.models import renderers

    original = renderers.render_rgb
    monkeypatch.setattr(renderers, "render_rgb", lambda *a, **kw: original(*a, **kw) * 0.98)
    assert run_cell("signerf_nerfacto.render", hooks(traffic=dict(TINY_RENDER))) == 0
    assert last_line(capsys)["correct"] is False


def test_refine_unchanged_state_is_caught(capsys, monkeypatch):
    from signerf_tpu_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupedAdam, "step", lambda self: None)
    assert run_cell("signerf.refine", hooks(traffic=dict(TINY_TRAIN))) == 0
    line = last_line(capsys)
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_refine_half_batch_is_caught(capsys):
    from drivers import train

    undo = train.plant_half_batch()
    try:
        assert run_cell("signerf.refine", hooks(traffic=dict(TINY_TRAIN))) == 0
    finally:
        undo()
    assert last_line(capsys)["correct"] is False


def test_refine_one_base_level_without_its_gradient_is_caught(capsys):
    from drivers import train

    undo = train.plant_base_level(4)
    try:
        assert run_cell("signerf.refine", hooks(traffic=dict(TINY_TRAIN))) == 0
    finally:
        undo()
    line = last_line(capsys)
    check = line["checks"]["grad_gap.base_l4"]
    assert line["correct"] is False and check["value"] == pytest.approx(1.0) and check["value"] > check["limit"]


def test_render_traced_run_checks_the_profiled_frames_it_drew(capsys):
    tiny = dict(TINY_RENDER, check_frames=2, check_within=2, trace_after_s=0.0)
    assert run_cell("signerf_nerfacto.render", hooks(traffic=tiny), trace=1) == 0
    out, err = capsys.readouterr()
    assert "reference: 2 frames" in err  # frame 0 in the loop, frame 1 under the profiler
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True


def test_refine_traced_run_reports_per_layer_metrics(capsys):
    assert run_cell("signerf.refine", hooks(traffic=dict(TINY_TRAIN)), trace=1) == 0
    line = last_line(capsys)
    assert "train_mfu.train" in line["metrics"] and "busy_s" in line["device"]


def test_dp_without_the_exchange_is_caught(capsys):
    h = hooks(traffic=dict(TINY_TRAIN, ranks=2), fault="no_exchange")
    assert run_cell("signerf.refine.dp4", h) == 0
    line = last_line(capsys)
    assert line["correct"] is False and line["checks"]["rank_gap"]["value"] > 0.0
    assert line["device"]["count"] == 2


def test_dp_sound_ranks_agree(capsys):
    assert run_cell("signerf.refine.dp4", hooks(traffic=dict(TINY_TRAIN, ranks=2))) == 0
    assert last_line(capsys)["checks"]["rank_gap"]["value"] == 0.0


def test_dp_forbidden_module_in_one_rank_refuses_the_result(capsys):
    h = hooks(traffic=dict(TINY_TRAIN, ranks=2), plant_module=(1, "jax"))
    assert run_cell("signerf.refine.dp4", h) == 4
    out, err = capsys.readouterr()
    assert "'rank 1': ['jax']" in err and "rank 0" not in err
    assert not any(row.startswith("{") for row in out.splitlines())
