"""The SDXL port's last two pieces against the JAX package at
`TINY_SDXL_CONFIG` on the CPU: the VAE's posterior sample
(`encode(..., noise=)` and `encode_from_features(..., noise=)` with JAX's
own draws, and the explicit-generator route), and weights converted for
the JAX package (`sdxl_params.msgpack`, flax's msgpack of the params tree,
as `scripts/convert_sdxl_weights.py` writes it) read by
`SDXLInpaintPipeline.create`: every tensor as the `.pt` route loads it, one
img2img bit for bit equal to the `.pt` route's and within the pipeline
tests' tolerance of JAX's, the `.pt` file first when both are there, the
decoder's read-only views of a mapped file, and chip_smoke.py's own writer
of that format.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from signerf_tpu_torch.convert import load_sdxl_from_jax_, sdxl_from_jax
from signerf_tpu_torch.diffusion import sdxl_pipeline as torch_pipe
from signerf_tpu_torch.engine.checkpoints import msgpack_restore, msgpack_restore_file
from tests.torch_diffusion_helpers import JaxDraws, rel, seeded_params, tiny_pipelines, to_np

torch.set_num_threads(2)

VAE_TOL = 2e-2  # tests/test_torch_diffusion_modules.py's VAE tolerance
TOL = 6e-2  # tests/test_torch_diffusion_pipeline.py's img2img tolerance
STEPS = 3
H = W = 16


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines(seed=1)


def test_vae_posterior_sample_matches_jax(pipes):
    """`encode` and `encode_from_features` given JAX's bf16 normal draws
    against JAX's `encode(rng=)` / `encode_from_features(rng=)`; without a
    draw, the mean bit for bit; a generator draws a standard normal in the
    latents' dtype, the same for the same seed."""
    jp, tp, _ = pipes
    img = (np.random.default_rng(2).random((1, 24, 16, 3)) * 2 - 1).astype(np.float32)
    p = {"params": jp.params["vae"]}
    key = jax.random.PRNGKey(7)
    jz = jp.vae.apply(p, img, rng=key, method="encode")
    jf = jp.vae.apply(p, img, method="encode_down")
    jz2 = jp.vae.apply(p, jf, rng=key, method="encode_from_features")
    jmean = jp.vae.apply(p, img, method="encode")
    eps = torch.from_numpy(to_np(jax.random.normal(key, tuple(jz.shape), jnp.bfloat16))).to(torch.bfloat16)
    ft = torch.from_numpy(to_np(jf)).to(torch.bfloat16)
    x = torch.from_numpy(img)
    with torch.no_grad():
        z = tp.vae.encode(x, noise=eps)
        z2 = tp.vae.encode_from_features(ft, noise=eps)
        mean = tp.vae.encode(x)
        assert z.dtype == torch.bfloat16 and tuple(z.shape) == tuple(jz.shape) == (1, 12, 8, 4)
        assert rel(to_np(z), to_np(jz)) < VAE_TOL
        assert rel(to_np(z2), to_np(jz2)) < VAE_TOL
        assert rel(to_np(mean), to_np(jmean)) < VAE_TOL
        # the sample is not the mean: it moved as far as JAX's did
        moved_t, moved_j = rel(to_np(z), to_np(mean)), rel(to_np(jz), to_np(jmean))
        assert moved_t > 0.01 and abs(moved_t - moved_j) < 0.1 * moved_j
        torch.testing.assert_close(tp.vae.encode(x, generator=None, noise=None), mean, rtol=0, atol=0)
        a = tp.vae.encode(x, generator=torch.Generator().manual_seed(3))
        b = tp.vae.encode(x, generator=torch.Generator().manual_seed(3))
        c = tp.vae.encode(x, generator=torch.Generator().manual_seed(4))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c) and not torch.equal(a, mean)
        g = tp.vae.encode_from_features(tp.vae.encode_down(x), generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(g, a, rtol=0, atol=0)  # the same moments and draw


def write_jax_weights(params, directory):
    """The JAX side's file: flax's msgpack of the f32 params tree."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "sdxl_params.msgpack").write_bytes(serialization.msgpack_serialize(params))
    return directory


def create(directory):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = torch_pipe.SDXLInpaintPipeline.create(directory, config=torch_pipe.TINY_SDXL_CONFIG, device="cpu")
    return pipe, [str(w.message) for w in caught if "RANDOM-INIT" in str(w.message)]


def state(pipe):
    return {f"{c}.{k}": v for c in torch_pipe.COMPONENTS for k, v in getattr(pipe, c).state_dict().items()}


def test_create_reads_jax_msgpack_weights(pipes, tmp_path):
    jp, _, params = pipes
    jax_dir = write_jax_weights(params, tmp_path / "jax")
    pt_dir = tmp_path / "pt"
    pt_dir.mkdir()
    torch.save(sdxl_from_jax(params), pt_dir / "sdxl_params.pt")
    from_msgpack, warned = create(jax_dir)
    assert warned == []
    from_pt, warned = create(pt_dir)
    assert warned == []
    a, b = state(from_msgpack), state(from_pt)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.bfloat16, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    rng = np.random.default_rng(0)
    img = rng.random((H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W, 1), np.float32)
    mask[2:10, 3:12] = 1.0
    depth = np.linspace(0, 1, H * W, dtype=np.float32).reshape(H, W, 1)
    kw = dict(mask=mask, control_image=depth, num_steps=STEPS, seed=3)
    got = from_msgpack.img2img(img, "a prompt", noise_source=JaxDraws(3), **kw)
    np.testing.assert_array_equal(got, from_pt.img2img(img, "a prompt", noise_source=JaxDraws(3), **kw))
    want = to_np(jp.img2img(img, "a prompt", **kw))
    assert rel(got, want) < TOL


def test_pt_file_takes_precedence_and_the_warning_names_both(pipes, tmp_path):
    """With both files the port's `.pt` wins; with neither, the
    RANDOM-INIT warning names both."""
    _, _, params = pipes
    other = seeded_params(jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params), 5)
    both = write_jax_weights(other, tmp_path / "both")
    torch.save(sdxl_from_jax(params), both / "sdxl_params.pt")
    pipe, warned = create(both)
    assert warned == []
    want = sdxl_from_jax(params)["unet"]
    for k, v in pipe.unet.state_dict().items():
        torch.testing.assert_close(v, want[k].to(torch.bfloat16), rtol=0, atol=0)
    _, warned = create(tmp_path / "none")
    assert len(warned) == 1 and "sdxl_params.pt" in warned[0] and "sdxl_params.msgpack" in warned[0]


def test_msgpack_file_decodes_to_read_only_views(pipes, tmp_path):
    """`msgpack_restore_file` maps the file and hands back views of it (no
    array is copied), equal to the bytes decoder's copies; the streaming
    loader is strict about names and shapes."""
    _, _, params = pipes
    path = write_jax_weights(params, tmp_path / "jax") / "sdxl_params.msgpack"
    views = msgpack_restore_file(path)
    raw = path.read_bytes()
    copies = msgpack_restore(raw)
    a, b = views["vae"]["decoder"]["conv_out"]["kernel"], views["unet"]["core"]["conv_in"]["kernel"]
    # both leaves sit in one buffer at their offsets in the file
    assert b.data_ptr() - a.data_ptr() == raw.find(b.numpy().tobytes()) - raw.find(a.numpy().tobytes())
    for leaf, ref in ((a, params["vae"]["decoder"]["conv_out"]["kernel"]), (b, params["unet"]["core"]["conv_in"]["kernel"])):
        np.testing.assert_array_equal(leaf.numpy(), ref)
    np.testing.assert_array_equal(copies["unet"]["core"]["conv_in"]["kernel"].numpy(), b.numpy())
    mods = {k: m.to_empty(device="cpu") for k, m in
            torch_pipe.SDXLInpaintPipeline.build_modules(torch_pipe.TINY_SDXL_CONFIG).items()}
    del views["vae"]["decoder"]["conv_out"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_sdxl_from_jax_(mods, views)
    views["vae"]["decoder"]["conv_out"]["bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        load_sdxl_from_jax_(mods, views)


def test_chip_smoke_msgpack_writer_is_flax_format(pipes):
    """chip_smoke.py's own writer of flax's msgpack (it imports neither
    flax, which the card's machine lacks, nor msgpack) gives bytes that
    flax and the port's decoder read back to the same arrays."""
    import io
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, _, params = pipes
    tree = {"vae": params["vae"], "odd": {"scalar": np.float32(3.5).reshape(()), "wide": np.zeros((70000,), np.float32)}}

    def lazy(node):
        return {k: lazy(v) if isinstance(v, dict) else (lambda v=v: np.ascontiguousarray(v, np.float32))
                for k, v in node.items()}

    buf = io.BytesIO()
    assert chip_smoke.write_flax_msgpack(buf, lazy(tree)) == len(buf.getvalue())
    raw = buf.getvalue()
    by_flax, ours = serialization.msgpack_restore(raw), msgpack_restore(raw)
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        a, b = by_flax, ours
        for k in keys:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(np.asarray(a), want)
        np.testing.assert_array_equal(b.numpy(), want)
