"""The diffusion port's modules against the JAX package's on the CPU, at the
tiny config and with the same seeded params (carried across by
`convert.sdxl_from_jax`): both CLIP towers, the UNet with and without
ControlNet residuals, the ControlNet with non-zero zero convs, the VAE's
six entry points (and its query-chunked mid attention), and a UNet at head
dim 64 whose self-attention takes K7's route. Then the weights: the JAX
params cover the port's state dicts exactly, and the port's diffusers name
map is a bijection onto the vendored diffusers inventory at the full SDXL
config, with the full-size modules built on the meta device.

Tolerances are norm-relative. Both packages compute in bf16 with the same
rounding points, but the CPU matmuls and convolutions sum in other orders
and a flipped bf16 rounding carries through the layers: 2e-2 for the CLIP
towers and the VAE halves, 4e-2 for the UNet and the ControlNet (measured
up to ~1.8e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signerf_tpu.diffusion import unet as jax_unet
from signerf_tpu.diffusion import vae as jax_vae
from signerf_tpu_torch.convert import sdxl_from_jax
from signerf_tpu_torch.diffusion import sdxl_pipeline as torch_pipe
from signerf_tpu_torch.diffusion import unet as torch_unet
from signerf_tpu_torch.diffusion import vae as torch_vae
from signerf_tpu_torch.diffusion import weight_conversion as wc
from signerf_tpu_torch.ops import flash_attention as fa
from tests.torch_diffusion_helpers import rel, seeded_params, tiny_pipelines, to_np

torch.set_num_threads(2)

CLIP_TOL = 2e-2
VAE_TOL = 2e-2
UNET_TOL = 4e-2


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines(seed=0)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tower", ["clip_l", "clip_g"])
def test_clip_tower_matches_jax(pipes, tower):
    jp, tp, _ = pipes
    ids = np.stack([jp.tokenizer("a red chair on the table"), jp.tokenizer("")])
    want = getattr(jp, tower).apply({"params": jp.params[tower]}, jnp.asarray(ids))
    with torch.no_grad():
        got = getattr(tp, tower)(torch.from_numpy(ids.astype(np.int64)))
    assert len(got) == len(want) == (4 if tower == "clip_g" else 3)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel(to_np(a), to_np(b)) < CLIP_TOL


def test_prompt_encoding_matches_jax(pipes):
    jp, tp, _ = pipes
    ctx_j, pooled_j = jp.encode_prompt("hello", "bad")
    ctx_t, pooled_t = tp.encode_prompt("hello", "bad")
    assert tuple(ctx_t.shape) == (2, 77, 32) and tuple(pooled_t.shape) == (2, 16)
    assert rel(to_np(ctx_t), to_np(ctx_j)) < CLIP_TOL
    assert rel(to_np(pooled_t), to_np(pooled_j)) < CLIP_TOL
    assert tp.encode_prompt("hello", "bad")[0] is ctx_t  # cached


def _unet_inputs(jp, seed=0, hw=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    cond = rng.random((2, hw * 2, hw * 2, 3)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx, pooled = (to_np(a) for a in jp.encode_prompt("p", "n"))
    tids = np.array([[16, 16, 0, 0, 16, 16]] * 2, np.float32)
    return x, cond, t, ctx, pooled, tids


def test_controlnet_matches_jax(pipes):
    jp, tp, params = pipes
    assert np.abs(params["controlnet"]["zero_conv_0"]["kernel"]).max() > 0
    x, cond, t, ctx, pooled, tids = _unet_inputs(jp)
    jd, jm = jp.controlnet.apply({"params": jp.params["controlnet"]}, x, cond, t, ctx, pooled, tids)
    with torch.no_grad():
        td, tm = tp.controlnet(*_t(x, cond, t, ctx, pooled, tids))
    assert len(td) == len(jd) == tp.controlnet.num_residuals
    for a, b in zip(td + [tm], list(jd) + [jm]):
        assert np.linalg.norm(to_np(b)) > 0  # the zero convs are not zero here
        assert rel(to_np(a), to_np(b)) < UNET_TOL


@pytest.mark.parametrize("control", [False, True])
def test_unet_matches_jax(pipes, control):
    jp, tp, _ = pipes
    x, cond, t, ctx, pooled, tids = _unet_inputs(jp, seed=1)
    jkw, tkw = {}, {}
    if control:
        jd, jm = jp.controlnet.apply({"params": jp.params["controlnet"]}, x, cond, t, ctx, pooled, tids)
        jkw = dict(extra_down_residuals=[r * jnp.float32(0.8) for r in jd], extra_mid_residual=jm * jnp.float32(0.8))
        with torch.no_grad():
            td, tm = tp.controlnet(*_t(x, cond, t, ctx, pooled, tids))
        s = torch.tensor(0.8)
        tkw = dict(extra_down_residuals=[r.float() * s for r in td], extra_mid_residual=tm.float() * s)
    want = jp.unet.apply({"params": jp.params["unet"]}, x, t, ctx, pooled, tids, **jkw)
    with torch.no_grad():
        got = tp.unet(*_t(x, t, ctx, pooled, tids), **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 8, 4)
    assert rel(to_np(got), to_np(want)) < UNET_TOL


def test_vae_entry_points_match_jax(pipes):
    jp, tp, _ = pipes
    rng = np.random.default_rng(2)
    img = (rng.random((1, 24, 16, 3)) * 2 - 1).astype(np.float32)
    p = {"params": jp.params["vae"]}
    jz = jp.vae.apply(p, img, method="encode")
    jf = jp.vae.apply(p, img, method="encode_down")
    jz2 = jp.vae.apply(p, jf, method="encode_from_features")
    jx = jp.vae.apply(p, jz, method="decode")
    jm = jp.vae.apply(p, jz, method="decode_mid")
    ju = jp.vae.apply(p, jm, method="decode_up")
    zt = torch.from_numpy(to_np(jz)).to(torch.bfloat16)
    mt = torch.from_numpy(to_np(jm)).to(torch.bfloat16)
    ft = torch.from_numpy(to_np(jf)).to(torch.bfloat16)
    with torch.no_grad():
        got = {
            "encode": (tp.vae.encode(torch.from_numpy(img)), jz),
            "encode_down": (tp.vae.encode_down(torch.from_numpy(img)), jf),
            "encode_from_features": (tp.vae.encode_from_features(ft), jz2),
            "decode": (tp.vae.decode(zt), jx),
            "decode_mid": (tp.vae.decode_mid(zt), jm),
            "decode_up": (tp.vae.decode_up(mt), ju),
        }
    assert tuple(got["encode"][0].shape) == (1, 12, 8, 4) and tuple(got["decode"][0].shape) == (1, 24, 16, 3)
    for name, (a, b) in got.items():
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel(to_np(a), to_np(b)) < VAE_TOL, name


def test_vae_chunked_mid_attention_matches_jax(pipes, monkeypatch):
    """With the chunk gate monkeypatched small, both packages take the
    query-chunked mid attention (ragged last chunk) on a 12x8 latent."""
    jp, tp, _ = pipes
    for mod in (jax_vae, torch_vae):
        monkeypatch.setattr(mod, "ATTN_CHUNK_TOKENS", 8)
        monkeypatch.setattr(mod, "ATTN_QUERY_CHUNK", 40)
    z = np.random.default_rng(3).standard_normal((1, 12, 8, 4)).astype(np.float32)
    want = jp.vae.apply({"params": jp.params["vae"]}, z, method="decode_mid")
    with torch.no_grad():
        got = tp.vae.decode_mid(torch.from_numpy(z))
        monkeypatch.setattr(torch_vae, "ATTN_CHUNK_TOKENS", 8192)
        plain = tp.vae.decode_mid(torch.from_numpy(z))
    assert rel(to_np(got), to_np(want)) < VAE_TOL
    assert rel(to_np(got), to_np(plain)) < 1e-2  # bf16 reciprocal scale vs division


HD64_CONFIG = dataclasses.replace(
    jax_unet.TINY_UNET_CONFIG, block_out_channels=(64, 128), attention_head_dim=64, norm_groups=8)


def test_unet_at_head_dim_64_through_the_k7_route(monkeypatch):
    """A narrow UNet whose self-attentions are head dim 64 (1 and 2 heads):
    the port routes them to K7's wrapper (its twin on the CPU); JAX runs its
    `_flash_self_attention` reference (FLASH_REFERENCE_IMPL)."""
    monkeypatch.setattr(jax_unet, "FLASH_REFERENCE_IMPL", True)
    monkeypatch.setattr(jax_unet, "FLASH_SCORE_BYTES_THRESHOLD", 1)
    jcfg = HD64_CONFIG
    tcfg = torch_unet.UNetConfig(**dataclasses.asdict(jcfg))
    model = jax_unet.UNet2DConditionModel(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.array([321.0], np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    tids = np.array([[16, 16, 0, 0, 16, 16]], np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, t, ctx, pooled, tids)["params"])
    params = seeded_params(shapes, seed=5)
    want = model.apply({"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)},
                       x, t, ctx, pooled, tids)
    port = torch_unet.UNet2DConditionModel(tcfg, pooled_dim=16).requires_grad_(False)
    port.load_state_dict(sdxl_from_jax({c: params for c in ("unet", "controlnet", "vae", "clip_l", "clip_g")})["unet"])
    calls = []
    real = torch_unet.flash_attention
    monkeypatch.setattr(torch_unet, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    before = fa.launches
    got = port(*_t(x, t, ctx, pooled, tids))
    assert sorted(set(calls)) == [(1, 16, 2, 64), (1, 64, 1, 64)]
    assert len(calls) == 2 + 1 + 4  # down (1 a block), mid (depth 1), up (2 a block)
    assert fa.launches == before  # CPU tensors: no kernel launch
    assert rel(to_np(got), to_np(want)) < UNET_TOL


# ---------------------------------------------------------------------------
# weights


def test_sdxl_from_jax_covers_every_leaf_once(pipes):
    _, _, params = pipes
    state = sdxl_from_jax(params)
    with torch.device("meta"):
        modules = torch_pipe.SDXLInpaintPipeline.build_modules(torch_pipe.TINY_SDXL_CONFIG)
    for comp, mod in modules.items():
        n_leaves = len(jax.tree_util.tree_leaves(params[comp]))
        want = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in state[comp].items()}
        assert len(got) == n_leaves == len(want)
        assert got == want, comp


@pytest.fixture(scope="module")
def full_modules():
    with torch.device("meta"):
        return torch_pipe.SDXLInpaintPipeline.build_modules(torch_pipe.SDXLConfig())


@pytest.mark.parametrize("component", ["unet", "controlnet", "vae", "clip_l", "clip_g"])
def test_name_map_bijective_against_diffusers_inventory(full_modules, component):
    from tests.fixtures.diffusers_sdxl_inventory import ALLOWED_UNUSED, INVENTORIES

    inventory = INVENTORIES[component]()
    module = full_modules[component]
    assert next(module.parameters()).device.type == "meta"
    expected = wc.expected_torch_keys(component, module)
    assert len(expected) == len(module.state_dict())  # no two port keys on one diffusers key
    inv_keys = set(inventory) - ALLOWED_UNUSED[component]
    assert not sorted(inv_keys - set(expected)), "unconsumed diffusers keys"
    assert not sorted(set(expected) - inv_keys), "port parameters without a source"
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    for tkey, (key, kind) in expected.items():
        tshape = tuple(inventory[tkey])
        got = (tshape[1], tshape[0]) if kind == "kernel" and len(tshape) == 2 else tshape
        assert got == shapes[key], (tkey, key)


def test_full_unet_size(full_modules):
    assert len(full_modules["unet"].state_dict()) == 1680  # SDXL base 1.0's UNet state dict
    n = sum(p.numel() for p in full_modules["unet"].parameters())
    assert 2.5e9 < n < 2.6e9


def test_diffusers_state_dict_converts_into_the_port(pipes):
    """A diffusers-layout state dict (built from the JAX params through the
    JAX package's own map) converts into the port's names and loads into
    the tiny modules, equal to `sdxl_from_jax`."""
    from signerf_tpu.diffusion import weight_conversion as jax_wc

    _, _, params = pipes
    direct = sdxl_from_jax(params)
    for comp in ("unet", "controlnet", "vae", "clip_l", "clip_g"):
        sd = {}
        for tkey, (path, kind) in jax_wc.expected_torch_keys(comp, params[comp]).items():
            leaf = params[comp]
            for k in path:
                leaf = leaf[k]
            arr = np.asarray(leaf)
            if kind == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[tkey] = arr
        got = wc.convert_component(comp, direct[comp], sd)
        assert got.keys() == direct[comp].keys()
        for k in got:
            assert torch.equal(got[k], direct[comp][k]), (comp, k)
    with pytest.raises(KeyError, match="unmatched"):
        wc.convert_component("vae", direct["vae"], {})
