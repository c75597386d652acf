"""The port's `SDXLInpaintPipeline.img2img` against the JAX package's at the
tiny config on the CPU, with the same seeded params and JAX's own noise
draws fed in through the port's `noise_source`: a single image, a batch of
two views, the serial-views gate, sequential vs batched CFG, the three
control modes and the four fill modes.

Tolerance: 6e-2 of the norm of the [0, 1] output. Both packages run the
same bf16 graph, but a flipped bf16 rounding in any of the ~100 layers
moves eps a little, and three ancestral steps of a random-weight UNet
carry it to the pixels (measured 0.7% to 3.3% over these modes)."""

import numpy as np
import pytest
import torch

from signerf_tpu.diffusion import unet as jax_unet
from signerf_tpu_torch.diffusion import sdxl_pipeline as torch_pipe
from signerf_tpu_torch.diffusion import unet as torch_unet
from tests.torch_diffusion_helpers import JaxDraws, rel, tiny_pipelines, to_np

torch.set_num_threads(2)

TOL = 6e-2
STEPS = 3  # strength 0.9 -> 2 sampler steps
H = W = 16


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = tiny_pipelines(seed=1)
    return jp, tp


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.random((2, H, W, 3)).astype(np.float32)
    mask = np.zeros((2, H, W, 1), np.float32)
    mask[0, 2:10, 3:12] = 1.0
    mask[1, 8:, :6] = 1.0
    depth = np.linspace(0, 1, H * W, dtype=np.float32).reshape(H, W, 1)
    return img, mask, depth


def both(pipes, image, seed=3, **kw):
    jp, tp = pipes
    want = to_np(jp.img2img(image, "a prompt", num_steps=STEPS, seed=seed, **kw))
    got = tp.img2img(image, "a prompt", num_steps=STEPS, seed=seed, noise_source=JaxDraws(seed), **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    return got, want


def test_single_image_with_mask_and_control(pipes, inputs):
    img, mask, depth = inputs
    got, want = both(pipes, img[0], mask=mask[0], control_image=depth)
    assert got.shape == (H, W, 3)
    assert rel(got, want) < TOL
    assert not pipes[1].last_run["sequential_cfg"]


def test_single_image_without_mask(pipes, inputs):
    got, want = both(pipes, inputs[0][1])
    assert rel(got, want) < TOL


def test_batch_of_two_views(pipes, inputs):
    img, mask, depth = inputs
    got, want = both(pipes, img, mask=mask, control_image=depth)
    assert got.shape == (2, H, W, 3)
    assert pipes[1].last_run["k_batch"] == 2
    assert rel(got, want) < TOL


def test_serial_views_gate(pipes, inputs, monkeypatch):
    """A threshold between the K = 1 and K = 2 score bytes: both packages
    run the views one at a time, each with the seed's draws."""
    img, mask, depth = inputs
    worst = torch_pipe._worst_selfattn_scores(pipes[1].config.unet, H // 2, W // 2)
    for mod in (jax_unet, torch_unet):
        monkeypatch.setattr(mod, "FLASH_SCORE_BYTES_THRESHOLD", 3 * worst)
    got, want = both(pipes, img, mask=mask, control_image=depth)
    assert pipes[1].last_run["serial_views"] and pipes[1].last_run["k_batch"] == 1
    assert rel(got, want) < TOL
    for k in range(2):
        single = pipes[1].img2img(img[k], "a prompt", mask=mask[k], control_image=depth, num_steps=STEPS, seed=3,
                                  noise_source=JaxDraws(3))
        np.testing.assert_array_equal(got[k], single)


def test_sequential_cfg_equals_batched(pipes, inputs, monkeypatch):
    """Sequential CFG (forced by a threshold of 1 score byte) is the same
    math as the batched branches: equal within the bf16 rounding of batch 1
    against batch 2 products (1e-2), and within TOL of JAX's sequential run."""
    img, mask, depth = inputs
    tp = pipes[1]
    kw = dict(mask=mask[0], control_image=depth, num_steps=STEPS, seed=3)
    batched = tp.img2img(img[0], "a prompt", noise_source=JaxDraws(3), **kw)
    assert not tp.last_run["sequential_cfg"]
    for mod in (jax_unet, torch_unet):
        monkeypatch.setattr(mod, "FLASH_SCORE_BYTES_THRESHOLD", 1)
    got, want = both(pipes, img[0], mask=mask[0], control_image=depth)
    assert tp.last_run["sequential_cfg"]
    assert rel(got, batched) < 1e-2
    assert rel(got, want) < TOL


@pytest.mark.parametrize("mode", ["Balanced", "My prompt is more important", "ControlNet is more important"])
def test_control_modes(pipes, inputs, mode):
    img, mask, depth = inputs
    got, want = both(pipes, img[0], control_image=depth, control_mode=mode)
    assert rel(got, want) < TOL
    if mode != "Balanced":
        balanced = pipes[1].img2img(img[0], "a prompt", control_image=depth, num_steps=STEPS, seed=3,
                                    noise_source=JaxDraws(3))
        assert rel(got, balanced) > 1e-3  # the modes scale the residuals differently


def test_unknown_control_mode_raises(pipes, inputs):
    with pytest.raises(ValueError, match="control_mode"):
        pipes[1].img2img(inputs[0][0], "p", num_steps=STEPS, control_mode="loudest")


@pytest.mark.parametrize("fill", [0, 1, 2, 3])
def test_fill_modes(pipes, inputs, fill):
    img, mask, depth = inputs
    draws = JaxDraws(3)
    jp, tp = pipes
    want = to_np(jp.img2img(img[0], "a prompt", mask=mask[0], control_image=depth, num_steps=STEPS, seed=3,
                            inpainting_fill=fill))
    got = tp.img2img(img[0], "a prompt", mask=mask[0], control_image=depth, num_steps=STEPS, seed=3,
                     inpainting_fill=fill, noise_source=draws)
    assert (("fill", 0) in draws.calls) == (fill == 2)
    assert rel(got, want) < TOL
