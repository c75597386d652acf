"""The diffusion port's building blocks against the JAX package on the CPU:
K7's plain twin vs `_flash_self_attention`'s reference (the einsum with the
kernel's I/O contract) and vs an f32 reference, the routes that take the
twin for CPU tensors, the norms, the sampler's schedule, steps, blur, fill
modes and latent-mask resize, a 4-step Euler-a chain on JAX's draws, and
the tokenizers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signerf_tpu.diffusion import norms as jax_norms
from signerf_tpu.diffusion import sampler as JS
from signerf_tpu.diffusion import tokenizer as jax_tok
from signerf_tpu.diffusion import unet as jax_unet
from signerf_tpu_torch.diffusion import norms as torch_norms
from signerf_tpu_torch.diffusion import sampler as TS
from signerf_tpu_torch.diffusion import tokenizer as torch_tok
from signerf_tpu_torch.diffusion import unet as torch_unet
from signerf_tpu_torch.diffusion.layers import upsample_nearest_2x
from signerf_tpu_torch.ops import flash_attention as fa
from tests.torch_diffusion_helpers import JaxDraws, rel, to_np

torch.set_num_threads(2)


def _qkv(b, s, h, seed, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    to_bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return to_bf16(q * 2.0), to_bf16(k * 2.0), to_bf16(v)


def _f32_reference(q, k, v, scale):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    b, sq, h, d = q.shape
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64)).reshape(b, sq, h * d)


# K7's twin against the JAX function's reference: the same bf16 rounding
# points (bf16 scores and scale, f32 softmax, bf16 probabilities and PV);
# left is the CPU matmuls' summation order and a flipped bf16 rounding:
# 1e-2 of the norm. Against an f64 reference the twin carries bf16 score
# and probability rounding: 2e-2 of the norm (it is what K7 improves on).
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h", [1, 2, 10])
@pytest.mark.parametrize("s", [1, 77, 130, 257])
def test_k7_twin_matches_jax_reference(monkeypatch, s, h, b):
    monkeypatch.setattr(jax_unet, "FLASH_REFERENCE_IMPL", True)
    q, k, v = _qkv(b, s, h, seed=s * 31 + h * 7 + b)
    scale = 1.0 / 8.0
    want = to_np(jax_unet._flash_self_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale))
    got = fa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, h * 64)
    assert rel(to_np(got), want) < 1e-2
    assert rel(to_np(got), _f32_reference(q, k, v, scale)) < 2e-2


def test_k7_wrapper_takes_the_twin_for_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel must not be called for CPU tensors")

    monkeypatch.setattr(fa, "flash_attention_cuda", no_kernel)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 33, 2, seed=0))
    before = fa.launches
    out = fa.flash_attention(q, k, v, 0.125)
    assert fa.launches == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, 0.125))


def test_k7_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q, 0.125)


@pytest.mark.parametrize("flash", [True, False])
def test_cross_attention_route_on_cpu(monkeypatch, flash):
    """On a CPU tensor, the self-attention gate hands K7's wrapper the CPU
    tensor (which takes the twin) and the switch off takes the twin
    directly: both give the einsum path's output."""
    monkeypatch.setattr(torch_unet, "FLASH_ATTENTION", flash)
    calls = []
    real = torch_unet.flash_attention
    monkeypatch.setattr(torch_unet, "flash_attention", lambda *a: calls.append(1) or real(*a))
    attn = torch_unet.CrossAttention(128, 128, 2, 64)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        x = torch.randn(2, 40, 128, generator=gen).to(torch.bfloat16)
        out = attn(x)
        q, k, v = (m(x).view(2, 40, 2, 64) for m in (attn.to_q, attn.to_k, attn.to_v))
        want = attn.to_out(fa.flash_attention_plain(q, k, v, 0.125))
    assert len(calls) == (1 if flash else 0)
    assert torch.equal(out, want)


def test_k7_wrapper_checks_layout():
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q, 0.125)  # CPU, and head_dim 32


# ---------------------------------------------------------------------------
# norms: the same rounding points as the JAX modules; left is the f32
# summation order and a flipped bf16 rounding of the output: 1e-2 max abs
# on unit-scale outputs, 1e-3 of the norm.


def _norm_io(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal(shape) * 3.0 + 1.5, jnp.bfloat16).astype(jnp.float32))
    scale = rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 64, 32)])
def test_group_norm_matches_jax(shape):
    x, scale, bias = _norm_io(shape, seed=len(shape))
    want = to_np(jax_norms.GroupNormBF16(num_groups=8).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jnp.bfloat16)))
    mod = torch_norms.GroupNormBF16(shape[-1], 8, dtype=torch.float32)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(to_np(got) - want).max() < 1e-2 * np.abs(want).max()
    assert rel(to_np(got), want) < 1e-3


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 64, 32)])
def test_layer_norm_matches_jax(shape):
    x, scale, bias = _norm_io(shape, seed=7 + len(shape))
    want = to_np(jax_norms.LayerNormBF16().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jnp.bfloat16)))
    mod = torch_norms.LayerNormBF16(shape[-1], dtype=torch.float32)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel(to_np(got), want) < 1e-3


def test_clip_layer_norm_matches_flax():
    from flax import linen as nn

    x, scale, bias = _norm_io((2, 77, 48), seed=3)
    want = to_np(nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16)))
    mod = torch_norms.LayerNorm(48)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert rel(to_np(got), want) < 1e-5


# ---------------------------------------------------------------------------
# sampler


def test_schedule_and_sigma_tables_exact():
    np.testing.assert_array_equal(TS.make_sd_schedule(), JS.make_sd_schedule())
    for n in (1, 5, 20, 50):
        np.testing.assert_array_equal(TS.get_sigmas(n), JS.get_sigmas(n))
        for strength in (0.0, 0.3, 0.9, 1.0):
            np.testing.assert_array_equal(TS.strength_sigmas(TS.get_sigmas(n), strength),
                                          JS.strength_sigmas(JS.get_sigmas(n), strength))


def test_sigma_to_t_and_ancestral_step_match_jax():
    train = JS.make_sd_schedule()
    sig = JS.get_sigmas(20)
    for a, b in zip(sig[:-1], sig[1:]):
        # f32 log in numpy and in XLA may differ by an ulp: 1e-4 of a timestep
        assert abs(float(TS.sigma_to_t(a, train)) - float(JS.sigma_to_t(jnp.float32(a), train))) < 1e-4
        got = TS.get_ancestral_step(a, b)
        want = JS.get_ancestral_step(jnp.float32(a), jnp.float32(b))
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(TS.scale_model_input(torch.ones(1), sig[3])),
                               float(JS.scale_model_input(jnp.ones(1), jnp.float32(sig[3]))[0]), rtol=1e-7)


@pytest.mark.parametrize("radius", [0, 1, 4])
def test_gaussian_blur_matches_jax(radius):
    mask = (np.random.default_rng(radius).random((24, 20, 1)) > 0.6).astype(np.float32)
    want = np.asarray(JS.gaussian_blur(jnp.asarray(mask), radius))
    got = TS.gaussian_blur(torch.from_numpy(mask)[None], radius)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fill", [0, 1, 2, 3])
def test_fill_mode_matches_jax(fill):
    rng = np.random.default_rng(fill)
    img = rng.random((12, 10, 3)).astype(np.float32)
    mask = rng.random((12, 10, 1)).astype(np.float32)
    want = np.asarray(JS.apply_fill_mode(jnp.asarray(img), jnp.asarray(mask), fill))
    got = TS.apply_fill_mode(torch.from_numpy(img), torch.from_numpy(mask), fill).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("hw,f", [((16, 16), 2), ((24, 40), 8), ((1536, 1536), 8), ((96, 64), 8)])
def test_latent_mask_resize_matches_jax_antialiased(hw, f):
    """The pipeline's latent mask: jax.image.resize(..., "linear") downsamples
    with an antialiasing triangle kernel; F.interpolate would not."""
    h, w = hw
    mask = np.random.default_rng(h).random((1, h, w, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(mask), (1, h // f, w // f, 1), "linear"))
    got = TS.resize_linear(torch.from_numpy(mask), h // f, w // f).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    naive = torch.nn.functional.interpolate(torch.from_numpy(mask).permute(0, 3, 1, 2), (h // f, w // f),
                                            mode="bilinear").permute(0, 2, 3, 1).numpy()
    assert np.abs(naive - want).max() > 1e-3


def test_nearest_upsample_equals_jax_resize():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), "nearest"))
    np.testing.assert_array_equal(upsample_nearest_2x(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("inpaint", [False, True])
def test_euler_ancestral_chain_on_jax_draws(inpaint):
    """4 steps of Euler-a on JAX's draws with the same toy denoiser: the same
    f32 chain, so f32 rounding apart: 1e-5 of the norm."""
    rng = np.random.default_rng(1)
    init = np.asarray(jnp.asarray(rng.standard_normal((2, 6, 5, 4)), jnp.bfloat16).astype(jnp.float32))
    lmask = (rng.random((2, 6, 5, 1)) > 0.5).astype(np.float32)
    sigmas = JS.strength_sigmas(JS.get_sigmas(5), 0.9)

    def j_denoised(x, sigma, frac):
        return 0.7 * x / jnp.sqrt(sigma**2 + 1.0) + 0.1 * frac

    def t_denoised(x, sigma, frac):
        return 0.7 * TS.scale_model_input(x, sigma) + 0.1 * frac

    jspec = JS.InpaintSpec(jnp.asarray(init, jnp.bfloat16), jnp.asarray(lmask)) if inpaint else None
    want = np.asarray(JS.sample_euler_ancestral(jax.random.PRNGKey(4), j_denoised, jnp.asarray(init, jnp.bfloat16),
                                                jnp.asarray(sigmas), jspec))
    # The sampler's own keys (JaxDraws starts from the pipeline's rng); with
    # inpaint the JAX sampler splits twice a step, without it once.
    draws = JaxDraws(0)
    draws.k_init, draws.k = jax.random.split(jax.random.PRNGKey(4))
    if not inpaint:
        keys = []

        def noise(name, step, shape, dtype):
            if name == "init":
                return draws("init", 0, shape, dtype)
            while len(keys) <= step:
                draws.k, sub = jax.random.split(draws.k)
                keys.append(sub)
            return torch.from_numpy(to_np(jax.random.normal(keys[step], tuple(shape), jnp.float32)))
    else:
        noise = draws
    tinit = torch.from_numpy(init).to(torch.bfloat16)
    tspec = TS.InpaintSpec(tinit, torch.from_numpy(lmask)) if inpaint else None
    got = TS.sample_euler_ancestral(noise, t_denoised, tinit, sigmas, tspec).numpy()
    assert got.dtype == np.float32
    assert rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# tokenizers


def test_hash_tokenizer_ids_match():
    for text in ["", "a red chair on a table", "Don't change the image!", "x " * 100]:
        np.testing.assert_array_equal(torch_tok.HashTokenizer()(text), jax_tok.HashTokenizer()(text))


def test_clip_bpe_tokenizer_ids_match(tmp_path):
    vocab = {}
    for piece in ["a</w>", "r", "e", "d</w>", "re", "red</w>", "c", "h", "ai", "r</w>", "chai", "chair</w>", "!</w>",
                  "t", "o", "n</w>", "on</w>"]:
        vocab[piece] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nr e\nre d</w>\na i\nc h\nch ai\nchai r</w>\no n</w>\n")
    jt = jax_tok.load_tokenizer(tmp_path)
    tt = torch_tok.load_tokenizer(tmp_path)
    assert isinstance(tt, torch_tok.CLIPTokenizer)
    for text in ["a red chair!", "on a chair", "unknown words here"]:
        np.testing.assert_array_equal(tt(text), jt(text))
