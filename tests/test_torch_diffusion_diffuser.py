"""The port's per-view fast path and `Diffuser` against the JAX package's on
the CPU, at the tiny config with the same seeded params and JAX's draws:
`prepare_sheet_cache` + the windowed `img2img`, `Diffuser.diffuse` and
`diffuse_batch` in the in-process mode (under both its names) and in
`custom`, and the `remote_sdwebui` request against a stubbed
`requests.post`. Also: no silent CPU path, the seeded random init and the
weights file.

Tolerance for the images: 6e-2 of the norm, as in
tests/test_torch_diffusion_pipeline.py (bf16 rounding carried through two
random-weight sampler steps)."""

import json

import numpy as np
import pytest
import requests
import torch

from signerf_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from signerf_tpu.diffusion.diffuser import DiffuserConfig as JaxDiffuserConfig
from signerf_tpu_torch.diffusion import sdxl_pipeline as torch_pipe
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from tests.torch_diffusion_helpers import JaxDraws, rel, tiny_pipelines, to_np

torch.set_num_threads(2)

TOL = 6e-2


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = tiny_pipelines(seed=2)
    return jp, tp


def with_jax_draws(tp, monkeypatch):
    """Make the port pipeline draw JAX's noise for whatever seed it is given."""
    real = tp.img2img

    def img2img(*args, **kw):
        return real(*args, noise_source=JaxDraws(kw["seed"]), **kw)

    monkeypatch.setattr(tp, "img2img", img2img)


def test_windowed_last_cell_matches_jax(pipes):
    jp, tp = pipes
    h, cell = 128, 32
    rng = np.random.default_rng(0)
    sheet = rng.random((h, h, 3)).astype(np.float32)
    mask = np.zeros((h, h, 1), np.float32)
    mask[-cell:, -cell:] = 1.0
    depth = rng.random((h, h, 1)).astype(np.float32)
    jcache = jp.prepare_sheet_cache(sheet, (cell, cell))
    tcache = tp.prepare_sheet_cache(sheet, (cell, cell))
    assert tcache.window_lat == jcache.window_lat == (48, 48, 32, 32, 32, 32)
    assert rel(to_np(tcache.down_feats), to_np(jcache.down_feats)) < 2e-2
    newcell = sheet.copy()
    newcell[-cell:, -cell:] = rng.random((cell, cell, 3))
    kw = dict(mask=mask, control_image=depth, num_steps=3, seed=4)
    want = to_np(jp.img2img(newcell, "p", sheet_cache=jcache, **kw))
    got = tp.img2img(newcell, "p", sheet_cache=tcache, noise_source=JaxDraws(4), **kw)
    assert got.shape == want.shape == (64, 64, 3)
    assert tp.last_run["windowed"]
    assert rel(got, want) < TOL


def test_degenerate_window_is_the_full_path(pipes):
    """A sheet small enough that the window clamps to the whole sheet, at
    strength 0 (no sampler step, so only the VAE plumbing): the windowed
    path equals the full one up to bf16 rounding (the JAX package's bound,
    4e-2 max abs)."""
    _, tp = pipes
    h, cell = 64, 32
    rng = np.random.default_rng(1)
    sheet = rng.random((h, h, 3)).astype(np.float32)
    mask = np.zeros((h, h, 1), np.float32)
    mask[-cell:, -cell:] = 1.0
    cache = tp.prepare_sheet_cache(sheet, (cell, cell))
    assert cache.window_lat[:2] == (32, 32)
    full = tp.img2img(sheet, "p", mask=mask, num_steps=2, seed=3, strength=0.0)
    win = tp.img2img(sheet, "p", mask=mask, num_steps=2, seed=3, strength=0.0, sheet_cache=cache)
    assert tp.last_run["windowed"] and tp.last_run["sampler_steps"] == 0
    np.testing.assert_allclose(win, full, atol=4e-2, rtol=0)


@pytest.mark.parametrize("mode", ["torch_sdxl", "jax_sdxl"])
def test_diffuser_in_process_matches_jax(pipes, monkeypatch, mode):
    jp, tp = pipes
    with_jax_draws(tp, monkeypatch)
    rng = np.random.default_rng(1)
    imgs = rng.random((2, 16, 16, 3)).astype(np.float32)
    masks = (rng.random((2, 16, 16, 1)) > 0.5).astype(np.float32)
    depth = rng.random((2, 16, 16, 1)).astype(np.float32)
    knobs = dict(num_inference_steps=3, seed=6, controlnet_control_mode="My prompt is more important")
    port = Diffuser(DiffuserConfig(mode=mode, **knobs), pipeline=tp)
    ref = JaxDiffuser(JaxDiffuserConfig(mode="jax_sdxl", **knobs))
    ref._sdxl = jp
    got = port.diffuse(imgs[0], imgs[0], masks[0], depth[0])
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    assert rel(got, to_np(ref.diffuse(imgs[0], imgs[0], masks[0], depth[0]))) < TOL
    got_b = port.diffuse_batch(imgs, imgs, masks, depth)
    assert got_b.shape == (2, 16, 16, 3)
    assert rel(got_b, to_np(ref.diffuse_batch(imgs, imgs, masks, depth))) < TOL
    assert port.prepare_sheet_cache(imgs[0], (8, 8)).window_lat == ref.prepare_sheet_cache(imgs[0], (8, 8)).window_lat


def test_diffuser_custom_mode():
    seen = []

    def fake(original, rendered, mask, condition):
        seen.append((original.shape, rendered.shape, None if mask is None else mask.shape, condition))
        return original * 0.5

    img = np.full((8, 8, 3), 0.8, np.float32)
    port = Diffuser(DiffuserConfig(mode="custom"), custom_fn=fake)
    ref = JaxDiffuser(JaxDiffuserConfig(mode="custom"), custom_fn=fake)
    np.testing.assert_array_equal(port.diffuse(img, img, np.ones((8, 8, 1))), ref.diffuse(img, img, np.ones((8, 8, 1))))
    out = port.diffuse_batch(np.stack([img, img]), np.stack([img, img]))
    assert out.shape == (2, 8, 8, 3) and np.allclose(out, 0.4)
    assert port.prepare_sheet_cache(img, (4, 4)) is None
    assert seen[0] == ((8, 8, 3), (8, 8, 3), (8, 8, 1), None) and len(seen) == 4
    with pytest.raises(ValueError, match="custom_fn"):
        Diffuser(DiffuserConfig(mode="custom")).diffuse(img, img)
    with pytest.raises(ValueError, match="unknown diffuser mode"):
        Diffuser(DiffuserConfig(mode="nope")).diffuse(img, img)


def _remote(diffuser_cls, config_cls, monkeypatch, reply):
    sent = []

    class Response:
        def json(self):
            return reply

    def post(url, headers=None, data=None, timeout=None):
        sent.append((url, headers, json.loads(data), timeout))
        return Response()

    monkeypatch.setattr(requests, "post", post)
    rng = np.random.default_rng(3)
    img = rng.random((24, 16, 3)).astype(np.float32)
    mask = (rng.random((24, 16, 1)) > 0.5).astype(np.float32)
    cond = rng.random((24, 16, 1)).astype(np.float32)
    out = diffuser_cls(config_cls(mode="remote_sdwebui", port=7860)).diffuse(img, img * 0.5, mask, cond)
    return sent, out


def test_remote_sdwebui_payload_equals_jax(monkeypatch):
    from signerf_tpu_torch.utils.images import array_to_image, image_to_base64

    reply_img = np.random.default_rng(4).random((12, 8, 3)).astype(np.float32)
    reply = {"images": [image_to_base64(array_to_image(reply_img))]}
    sent_t, out_t = _remote(Diffuser, DiffuserConfig, monkeypatch, reply)
    sent_j, out_j = _remote(JaxDiffuser, JaxDiffuserConfig, monkeypatch, reply)
    assert len(sent_t) == len(sent_j) == 1
    assert sent_t[0][0] == "http://127.0.0.1:7860/sdapi/v1/img2img"
    assert sent_t == sent_j  # url, headers, payload (base64 PNGs included), timeout
    assert sent_t[0][2]["mask_blur"] == 4 and sent_t[0][2]["sampler_name"] == "Euler a"
    assert out_t.shape == (24, 16, 3)
    np.testing.assert_array_equal(out_t, out_j)


def test_remote_sdwebui_unreachable_returns_original(monkeypatch):
    def refuse(*args, **kwargs):
        raise requests.ConnectionError("refused")

    monkeypatch.setattr(requests, "post", refuse)
    img = np.random.default_rng(5).random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(Diffuser(DiffuserConfig(mode="remote_sdwebui")).diffuse(img, img), img)


def test_no_silent_cpu_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_pipe.SDXLInpaintPipeline.create(config=torch_pipe.TINY_SDXL_CONFIG)
    img = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Diffuser(DiffuserConfig()).diffuse(img, img)


def test_random_init_warns_and_is_seeded():
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        a = torch_pipe.SDXLInpaintPipeline.create(config=torch_pipe.TINY_SDXL_CONFIG, device="cpu", seed=3)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        b = torch_pipe.SDXLInpaintPipeline.create(config=torch_pipe.TINY_SDXL_CONFIG, device="cpu", seed=3)
    sa, sb = a.unet.state_dict(), b.unet.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(v.dtype == torch.bfloat16 for v in sa.values())
    zero = a.controlnet.state_dict()
    assert all(not zero[k].any() for k in zero if k.startswith(("zero_conv", "cond_conv_out")))
    kernel = sa["core.conv_in.kernel"].float()
    assert 0.5 < float(kernel.std() * (4 * 9) ** 0.5) < 1.5  # lecun normal: var 1 / fan_in


def test_weights_file_roundtrip(pipes, tmp_path):
    _, tp = pipes
    state = {name: getattr(tp, name).state_dict() for name in torch_pipe.COMPONENTS}
    torch.save(state, tmp_path / "sdxl_params.pt")
    loaded = torch_pipe.SDXLInpaintPipeline.create(weights_path=tmp_path, config=torch_pipe.TINY_SDXL_CONFIG,
                                                   device="cpu")
    for name in torch_pipe.COMPONENTS:
        got = getattr(loaded, name).state_dict()
        assert all(torch.equal(got[k], v) for k, v in state[name].items())
