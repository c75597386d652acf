"""One per-view regeneration (`generate_with_reference_sheet`) of the port's
dataset generator against the JAX package's, through the tiny in-process
SDXL pipelines with the same seeded params and JAX's draws
(tests/torch_diffusion_helpers.py), with the `lastcell_vae_window` cache
and without it; and the sheet cache taken on the sheet's shape alone, in
both packages alike.

The sheet is 2 x 3 cells of 36 px (72 x 108, padded to 72 x 112), so the
windowed decode returns a 68 x 68 window whose last cell sits 4 px in from
its right edge. Tolerances: the view's render, mask and condition and
their cell-size versions within 1e-6 (the same analytic render on both
sides); the edited cell and view within 6e-2 of the norm, the diffusion
tests' bound (bf16 rounding carried through random-weight sampler steps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from signerf_tpu.diffusion.diffuser import Diffuser as JDiffuser
from signerf_tpu.diffusion.diffuser import DiffuserConfig as JDiffuserConfig
from signerf_tpu.generator import datasetgenerator as jgen
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.generator import datasetgenerator as tgen
from tests.test_torch_edit_flow import jax_render, port_render, poses
from tests.torch_diffusion_helpers import JaxDraws, rel, tiny_pipelines, to_np

torch.set_num_threads(2)

TOL = 6e-2
SIZE, FOCAL = 72, 80.0


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = tiny_pipelines(seed=3)
    return jp, tp


def make_generators(tmp_path, jp, tp, monkeypatch):
    kw = dict(path=tmp_path, fx=FOCAL, fy=FOCAL, cx=SIZE / 2, cy=SIZE / 2, width=SIZE, height=SIZE,
              aabb_min=(-0.5, -0.5, -0.5), aabb_max=(0.5, 0.5, 0.5), mask_dilation=(5, 5))
    jcfg = jgen.DatasetGeneratorConfig(diffuser=JDiffuserConfig(mode="jax_sdxl", num_inference_steps=3), **kw)
    tcfg = tgen.DatasetGeneratorConfig(diffuser=DiffuserConfig(num_inference_steps=3), **kw)
    jdiff = JDiffuser(jcfg.diffuser)
    jdiff._sdxl = jp
    real = tp.img2img
    monkeypatch.setattr(tp, "img2img", lambda *a, **k: real(*a, noise_source=JaxDraws(k["seed"]), **k))
    jg = jgen.DatasetGenerator(jcfg, np.eye(4)[:3], 1.0, lambda p: p, jax_render, diffuser=jdiff)
    tg = tgen.DatasetGenerator(tcfg, np.eye(4)[:3], 1.0, lambda p: p, port_render,
                               diffuser=Diffuser(tcfg.diffuser, pipeline=tp), device="cpu")
    return jg, tg


@pytest.mark.parametrize("lastcell_vae_window", [True, False])
def test_generate_with_reference_sheet_matches_jax(tmp_path, pipes, monkeypatch, lastcell_vae_window):
    jp, tp = pipes
    jg, tg = make_generators(tmp_path, jp, tp, monkeypatch)
    lo = tg._layout()
    assert (lo.height, lo.width, lo.cell_height) == (72, 112, 36)
    rng = np.random.default_rng(4)
    sheet = rng.random((lo.height, lo.width, 3)).astype(np.float32)
    cond = rng.random((lo.height, lo.width, 1)).astype(np.float32)
    pose = poses(1, 60.0, 0.0)
    jcams, tcams = jg._cameras_from_poses(pose), tg._cameras_from_poses(pose)
    jcache = tcache = None
    if lastcell_vae_window:
        jcache = jg.diffuser.prepare_sheet_cache(jnp.asarray(sheet), (lo.cell_height, lo.cell_width))
        tcache = tg.diffuser.prepare_sheet_cache(torch.from_numpy(sheet), (lo.cell_height, lo.cell_width))
        assert tuple(tcache.window_lat) == tuple(jcache.window_lat) == (36, 50, 34, 34, 34, 34)
    want = jg.generate_with_reference_sheet(jcams, 0, None, jnp.asarray(sheet), jnp.asarray(cond),
                                            sheet_cache=jcache)
    got = tg.generate_with_reference_sheet(tcams, 0, None, torch.from_numpy(sheet), torch.from_numpy(cond),
                                           sheet_cache=tcache)
    assert tp.last_run["windowed"] is lastcell_vae_window
    assert sorted(got) == sorted(want)
    for key in ("render", "mask", "condition", "render_scaled", "mask_scaled", "condition_scaled"):
        np.testing.assert_allclose(to_np(got[key]), to_np(want[key]), rtol=0, atol=1e-6, err_msg=key)
    assert float(got["mask_scaled"].mean()) > 0.0  # the view selects something
    assert tuple(got["edited_scaled"].shape) == (36, 36, 3) and tuple(got["edited"].shape) == (72, 72, 3)
    for key in ("edited_scaled", "edited"):
        assert np.isfinite(to_np(got[key])).all()
        assert rel(to_np(got[key]), to_np(want[key])) < TOL, key
    # outside the mask the edited cell is the render's
    outside = to_np(got["mask_scaled"])[..., 0] == 0
    np.testing.assert_array_equal(to_np(got["edited_scaled"])[outside], to_np(got["render_scaled"])[outside])


def test_sheet_cache_is_taken_on_shape_alone_in_both(pipes):
    """The inherited quirk, pinned: a cache built from sheet A is used for
    any sheet of A's size, so a sheet B that differs outside the splice
    window is regenerated from A's encoder features in both packages
    alike (the per-view loop always passes the sheet the cache was built
    from)."""
    jp, tp = pipes
    h, cell = 128, 32
    rng = np.random.default_rng(5)
    sheet_a = rng.random((h, h, 3)).astype(np.float32)
    sheet_b = sheet_a.copy()
    sheet_b[:32, :32] = rng.random((32, 32, 3))  # outside the window
    mask = np.zeros((h, h, 1), np.float32)
    mask[-cell:, -cell:] = 1.0
    depth = rng.random((h, h, 1)).astype(np.float32)
    kw = dict(mask=mask, control_image=depth, num_steps=3, seed=8)
    jcache, tcache = jp.prepare_sheet_cache(sheet_a, (cell, cell)), tp.prepare_sheet_cache(sheet_a, (cell, cell))
    want = to_np(jp.img2img(sheet_b, "p", sheet_cache=jcache, **kw))
    got = tp.img2img(sheet_b, "p", sheet_cache=tcache, noise_source=JaxDraws(8), **kw)
    assert tp.last_run["windowed"] and rel(got, want) < TOL
    own = tp.img2img(sheet_b, "p", sheet_cache=tp.prepare_sheet_cache(sheet_b, (cell, cell)),
                     noise_source=JaxDraws(8), **kw)
    assert not np.array_equal(got, own)  # A's features, not B's, went in
