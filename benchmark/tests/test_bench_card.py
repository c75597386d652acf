"""On the card: the controls at each one-card cell's own size, and one base
level's tables left without their gradient, three seeds, against the cells'
limits (`python -m pytest --noconftest -p no:cacheprovider
benchmark/tests/test_bench_card.py -q`, a few minutes on an H100). Skipped
without a card."""

from __future__ import annotations

import json

import pytest

from bench_helpers import BENCH_DIR  # noqa: F401

SEEDS = [4100000001, 4100000002, 4100000003]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["signerf.refine", "signerf_nerfacto.render"])
def test_control_fails_at_the_cells_size(card, workload):
    import run
    from harness import manifest

    run.set_caches()
    cell = manifest.find_cell(workload, manifest.load_manifest())
    out = manifest.driver_module(cell).calibrate(cell, [], SEEDS, [], None)
    lim = json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())["limits"]
    for seed, readings in out["control"].items():
        assert any(readings[k] > lim[k] for k in readings if k in lim), (seed, readings)


@pytest.mark.cuda
def test_one_base_level_without_its_gradient_fails_at_the_cells_size(card):
    import run
    from harness import manifest

    run.set_caches()
    cell = manifest.find_cell("signerf.refine", manifest.load_manifest())
    out = manifest.driver_module(cell).calibrate(cell, [], SEEDS, ["base_level_4"], None)
    lim = json.loads((BENCH_DIR / "limits" / "signerf.refine.json").read_text())["limits"]
    for seed, readings in out["faults"]["base_level_4"].items():
        assert readings["grad_gap.base_l4"] > lim["grad_gap.base_l4"], (seed, readings)
