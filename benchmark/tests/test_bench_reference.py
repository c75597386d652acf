"""The plain reference against itself at a tiny size: repeatable, the same
step in blocks of any size, a data-parallel step equal to one rank's over
the ranks' rays, and the eval render equal in any blocks."""

from __future__ import annotations

import json

import pytest
import torch

from bench_helpers import BENCH_DIR, TINY_MODEL


@pytest.fixture(scope="module")
def setup():
    from harness import scene as scene_lib
    from reference import nerf

    cfg = json.loads((BENCH_DIR / "configs" / "signerf.json").read_text())
    model = dict(cfg["model"], **TINY_MODEL)
    poses, focal, images = scene_lib.make_views(3, 48, "cpu")
    scene = type("Scene", (), {"poses": poses, "focal": focal, "images": images})
    gen = torch.Generator().manual_seed(7)
    w0 = nerf.init_params(nerf.param_shapes(model, 3), gen, "cpu")
    lp = nerf.init_lpips(gen, "cpu")
    return cfg, model, scene, w0, lp


def step(setup, states, block, rays=1024):
    from reference import nerf, train

    cfg, model, scene, w0, lp = setup
    params = {k: v.clone() for k, v in w0.items()}
    adam = nerf.Adam(cfg["optimizers"], params)
    loss, grads, after = train.train_step(params, adam, 0, states, scene, model, rays, 32, lp, nerf.FULL, block)
    return loss, grads, params


def test_train_step_repeats_and_blocks_agree(setup):
    state = torch.Generator().manual_seed(99).get_state()
    a = step(setup, [state], 2048, rays=2048)
    b = step(setup, [state], 2048, rays=2048)
    c = step(setup, [state], 1024, rays=2048)  # blocks of whole 32x32 patches
    # the tables' gradients are scatter-adds, summed in any order
    assert b[0] == pytest.approx(a[0], rel=1e-6)
    for k in a[1]:
        assert torch.allclose(b[1][k], a[1][k], rtol=1e-5, atol=1e-7 * float(a[1][k].abs().max()) + 1e-12)
    assert c[0] == pytest.approx(a[0], rel=1e-6)
    for k in a[1]:
        assert torch.allclose(c[1][k], a[1][k], rtol=1e-4, atol=1e-7 * float(a[1][k].abs().max()) + 1e-12)


def test_two_ranks_are_the_mean_of_their_batches(setup):
    """A data-parallel step over two ranks' draws is one step over both
    batches' mean: the mean of the two one-rank losses and gradients."""
    s1 = torch.Generator().manual_seed(1).get_state()
    s2 = torch.Generator().manual_seed(2).get_state()
    both = step(setup, [s1, s2], 1024)
    one = step(setup, [s1], 1024)
    two = step(setup, [s2], 1024)
    assert both[0] == pytest.approx(0.5 * (one[0] + two[0]), rel=1e-6)
    for k in both[1]:
        want = 0.5 * (one[1][k] + two[1][k])
        assert torch.allclose(both[1][k], want, rtol=1e-4, atol=1e-6 * float(want.abs().max()) + 1e-12)


def test_control_precision_differs_from_full(setup):
    from reference import nerf, train

    cfg, model, scene, w0, lp = setup
    state = torch.Generator().manual_seed(5).get_state()
    params = {k: v.clone() for k, v in w0.items()}
    full = train.train_step(params, nerf.Adam(cfg["optimizers"], params), 0, [state], scene, model, 1024, 32, lp,
                            nerf.FULL, 1024)
    params = {k: v.clone() for k, v in w0.items()}
    ctrl = train.train_step(params, nerf.Adam(cfg["optimizers"], params), 0, [state], scene, model, 1024, 32, lp,
                            nerf.CONTROL, 1024)
    assert ctrl[0] != full[0]


def test_render_blocks_agree(setup):
    from harness import scene as scene_lib
    from reference import nerf, train

    cfg, model, scene, w0, _ = setup
    nerfacto = dict(json.loads((BENCH_DIR / "configs" / "signerf_nerfacto.json").read_text())["model"], **TINY_MODEL)
    w = nerf.init_params(nerf.param_shapes(nerfacto, 3), torch.Generator().manual_seed(3), "cpu")
    o, d = scene_lib.pixel_rays(scene.poses[0], scene.focal, 16, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    near, far = nerf.aabb_near_far(o, d, -1.0, 1.0)
    a = train.render_rays(w, nerfacto, o, d, near, far, nerf.FULL, 256)
    b = train.render_rays(w, nerfacto, o, d, near, far, nerf.FULL, 64)
    for k in a:
        assert torch.allclose(a[k], b[k], rtol=1e-6, atol=1e-7)
    assert float(a["accumulation"].min()) >= 0.0 and float(a["rgb"].max()) <= 1.0
