"""The port's SDXL tensor parallelism (the `tensor` axis of
signerf_tpu_torch/parallel/mesh.py, the sharded blocks of
signerf_tpu_torch/diffusion/unet.py) on the CPU, against the port's own
one-rank runs and the JAX package's `_shard_params` on a ("tensor",) mesh:
(a) the tiny SDXL's ControlNet + UNet forward, (b) a 2-step `img2img`, (c)
the sharded GEGLU alone, (d) `shard_sdxl_state` and its inverse, on the
tiny config and on the full one built on the meta device, (e) the
generator on a (data=1, tensor=2) mesh, (f) no JAX in the ranks.

The ranks are one spawn of two gloo processes with tensor=2 (one thread
each, a `file://` rendezvous under the test's tmp_path); their work lives
in tests/torch_tensor_parallel_helpers.py, which imports torch and the port
only. The weights are tests/torch_diffusion_helpers.py's seeded numpy
params, carried across by `convert.sdxl_from_jax`.

Tolerances. TP sums each row-parallel product's two bf16 partials in f32
and rounds once, where one rank rounds the whole product once: a flipped
bf16 rounding per layer, which the blocks carry on. Measured on this CPU
at T=2 against T=1: eps 1.34e-2 norm-relative (max 0.027, mean 0.0058),
the mid residual 8.7e-3, the first residual (before any attention) equal.
The bounds: against T=1 and against JAX's TP mesh, test_diffusion.py's TP
bounds (max |err| < 0.15, mean < 2e-2) and the module tests' 4e-2
norm-relative; img2img's mean |err| within test_diffusion.py's 2e-2 (its
data-parallel sampler bound; measured 0.0039).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signerf_tpu.diffusion.sdxl_pipeline import _shard_params, tensor_parallel_pspecs
from signerf_tpu.parallel import get_mesh
from signerf_tpu_torch.convert import sdxl_from_jax, sdxl_shard, shard_sdxl_state, unshard_sdxl_state
from signerf_tpu_torch.diffusion import sdxl_pipeline as tsdxl
from signerf_tpu_torch.diffusion.layers import Dense
from signerf_tpu_torch.diffusion.unet import GEGLU, TensorShard
from tests import torch_parallel_helpers as hp
from tests import torch_tensor_parallel_helpers as tph
from tests.test_torch_edit_flow import GEN_CONFIG, png_arrays, poses
from tests.torch_diffusion_helpers import rel, tiny_pipelines, to_np

torch.set_num_threads(2)

RANKS = TENSOR = 2
UNET_TOL = 4e-2  # tests/test_torch_diffusion_modules.py
TP_MAX, TP_MEAN = 0.15, 2e-2  # tests/test_diffusion.py:262-263
IMG2IMG_MEAN = 2e-2  # tests/test_diffusion.py:299
GEN_PX = 24
# (e) The generator through the tiny SDXL at T=2 against T=1. The PNGs
# that no inpaint touches (renders, masks, conditions) are equal bit for
# bit; the edited ones carry (b)'s differences through the ancestral
# sampler and the 8-bit rounding: measured at most 12 levels apart, 1.21
# levels on average over the worst file. Bound: 32 levels, 4 on average
# (assert_same_dataset's rule, one level on 5% of the values, holds for
# the untouched PNGs, which are equal).
GEN_MAX_LEVELS, GEN_MEAN_LEVELS = 32, 4.0
EDITED = ("images/", "images_2/", "references/edited_reference_sheet.png")


def unet_inputs(jp, seed=0, hw=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    cond = rng.random((2, hw * 2, hw * 2, 3)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx, pooled = (to_np(a) for a in jp.encode_prompt("p", "n"))
    tids = np.array([[16, 16, 0, 0, 16, 16]] * 2, np.float32)
    return x, cond, t, ctx, pooled, tids


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Every case on two spawned gloo ranks with tensor=2, once; the same
    work on one rank in this process (one thread, as the ranks)."""
    tmp = tmp_path_factory.mktemp("tp")
    jp, _, params = tiny_pipelines(seed=0)
    state = sdxl_from_jax(params)
    rng = np.random.default_rng(1)
    mask = np.zeros((16, 16, 1), np.float32)
    mask[4:12, 4:12] = 1.0
    gen = dict(path=str(tmp / "ranks"), references=poses(3, 60.0, 240.0), views=poses(4, 75.0, 288.0),
               config=dict(GEN_CONFIG, width=GEN_PX, height=GEN_PX, cx=GEN_PX / 2, cy=GEN_PX / 2, fx=30.0, fy=30.0,
                           generation_batch_size=2))
    case = dict(state=state, inputs=unet_inputs(jp), image=rng.random((16, 16, 3)).astype(np.float32), mask=mask,
                depth=rng.random((16, 16, 1)).astype(np.float32), generate=gen)
    hp.spawn(tph.suite, (case, str(tmp)), RANKS, tmp, tensor=TENSOR)
    ranks = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in range(RANKS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = tph.tiny_pipeline(None, state)
        one = {"eps": tph.eps(whole, case), "img2img": tph.img2img(whole, case),
               "dataset": tph.generate(None, whole, dict(gen, path=str(tmp / "one")))}
    finally:
        torch.set_num_threads(threads)
    return {"jp": jp, "params": params, "state": state, "case": case, "ranks": ranks, "one": one, "whole": whole}


# ---------------------------------------------------------------------------
# (a) the forward, (b) img2img
# ---------------------------------------------------------------------------


def test_tp_forward_matches_one_rank(suite):
    """ControlNet + UNet (one CFG branch) at T=2 against T=1."""
    one, got = suite["one"]["eps"], suite["ranks"][0]["eps"]
    assert torch.equal(got["down0"], one["down0"])  # no attention before the first residual
    err = (got["eps"] - one["eps"]).abs()
    assert float(err.max()) < TP_MAX and float(err.mean()) < TP_MEAN, (float(err.max()), float(err.mean()))
    for k in ("eps", "mid"):
        assert rel(to_np(got[k]), to_np(one[k])) < UNET_TOL, k
    assert rel(to_np(got["eps"]), to_np(one["eps"])) > 0  # the sums did run in another order


def test_tp_forward_matches_jax_tensor_mesh(suite):
    """The same branch against the JAX package's UNet and ControlNet with
    `_shard_params` on a 2-device ("tensor",) mesh of the conftest's CPU
    devices (tests/test_diffusion.py's TP test at 2 devices)."""
    jp = suite["jp"]
    x, cond, t, ctx, pooled, tids = suite["case"]["inputs"]
    mesh = get_mesh(TENSOR, axis_names=("tensor",))
    sharded = _shard_params(jp.params, mesh)
    with mesh:
        jd, jm = jp.controlnet.apply({"params": sharded["controlnet"]}, x, cond, t, ctx, pooled, tids)
        want = jp.unet.apply({"params": sharded["unet"]}, x, t, ctx, pooled, tids,
                             extra_down_residuals=[r * jnp.float32(0.8) for r in jd],
                             extra_mid_residual=jm * jnp.float32(0.8))
    got, want = to_np(suite["ranks"][0]["eps"]["eps"]), to_np(want)
    err = np.abs(got - want)
    assert err.max() < TP_MAX and err.mean() < TP_MEAN, (err.max(), err.mean())
    assert rel(got, want) < UNET_TOL


def test_tensor_group_outputs_are_bit_equal(suite):
    r0, r1 = suite["ranks"]
    for k in r0["eps"]:
        assert torch.equal(r0["eps"][k], r1["eps"][k]), k
    assert np.array_equal(r0["img2img"], r1["img2img"])


def test_tp_img2img_matches_one_rank(suite):
    """A 2-step img2img (mask and depth control) at T=2 against T=1."""
    got, want = suite["ranks"][0]["img2img"], suite["one"]["img2img"]
    assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
    err = np.abs(got.astype(np.float64) - want)
    assert err.mean() < IMG2IMG_MEAN, err.mean()


def test_ranks_hold_half_of_the_sharded_bytes(suite):
    """Each rank holds 1/T of the sharded leaves and all of the rest."""
    whole, state = suite["whole"], suite["state"]
    total = sum(t.numel() * t.element_size() for t in whole.tensors())
    assert sum(1 for _ in whole.tensors(sharded=True)) == 0
    cut = sum(2 * t.numel() for comp, sd in state.items() for k, t in sd.items()
              if sdxl_shard(comp, k, t.shape, 0, TENSOR, head_dim=8) is not None)  # bf16 bytes
    assert cut > 0
    for r in suite["ranks"]:
        assert (r["sharded_bytes"], r["replicated_bytes"]) == (cut // TENSOR, total - cut)


# ---------------------------------------------------------------------------
# (c) GEGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["paired", "contiguous"])
def test_sharded_geglu_equals_the_whole_one(split):
    """Each rank's GEGLU (its 1/T of h and the matching 1/T of gate) gives
    its 1/T of the whole GEGLU's output, bit for bit; the contiguous split
    of [h | gate] that JAX's pspec names (GSPMD reshards it at the chunk)
    pairs rank 0's h with h and fails."""
    dim, width = 16, 64
    torch.manual_seed(0)
    whole = GEGLU(dim, width)
    with torch.no_grad():
        whole.proj.kernel.copy_(torch.randn(dim, 2 * width) / 4)
        whole.proj.bias.copy_(torch.randn(2 * width) / 8)
    x = torch.randn(3, 5, dim)
    want = whole(x)
    parts = []
    for r in range(TENSOR):
        tp = TensorShard(r, TENSOR)
        shard = tp.shard(1, 2 * width, blocks=2) if split == "paired" else tp.shard(1, 2 * width)
        geglu = GEGLU(dim, width, shard)
        with torch.no_grad():
            geglu.proj.kernel.copy_(shard.take(whole.proj.kernel))
            geglu.proj.bias.copy_(dataclasses.replace(shard, dim=0).take(whole.proj.bias))
        parts.append(geglu(x))
    got = torch.cat(parts, -1)
    if split == "paired":
        assert torch.equal(got, want)
    else:
        assert rel(to_np(got), to_np(want)) > 0.5


# ---------------------------------------------------------------------------
# (d) the shards of the weights
# ---------------------------------------------------------------------------


def sharded_modules(config, tp):
    with torch.device("meta"):
        return tsdxl.SDXLInpaintPipeline.build_modules(config, tp)


def test_shard_round_trip_is_exact_on_the_tiny_config(suite):
    """`shard_sdxl_state` gives each rank's modules their shapes, and
    `unshard_sdxl_state` of the ranks' parts is the whole state bit for
    bit; the ranks' own modules have those shapes."""
    state = suite["state"]
    parts = [shard_sdxl_state(state, r, TENSOR, head_dim=8) for r in range(TENSOR)]
    shapes = {comp: {k: tuple(v.shape) for k, v in sd.items()} for comp, sd in state.items()}
    back = unshard_sdxl_state(parts, shapes, head_dim=8)
    for comp in state:
        assert sorted(back[comp]) == sorted(state[comp])
        for k in state[comp]:
            assert torch.equal(back[comp][k], state[comp][k]), (comp, k)
    for r, part in enumerate(parts):
        mods = sharded_modules(tsdxl.TINY_SDXL_CONFIG, TensorShard(r, TENSOR))
        for comp in ("unet", "controlnet"):
            want = {k: tuple(v.shape) for k, v in mods[comp].state_dict().items()}
            assert want == {k: tuple(v.shape) for k, v in part[comp].items()}
            assert want == suite["ranks"][r]["shapes"][comp]


@pytest.mark.parametrize("tensor,kernels", [(2, 700), (4, 620)])
def test_full_unet_shards_as_jax(tensor, kernels):
    """On the full config (built on the meta device): at T=2 the 700 kernels
    that JAX's `tensor_parallel_pspecs` shards (70 blocks x q, k, v, out of
    both attentions and both FF matrices; tests/test_diffusion.py's count),
    and GEGLU's 70 proj biases; at T=4 the 10-head blocks' attentions run
    whole (10 blocks x 8 kernels). Every module's shard is the rule's, and
    the round trip is exact on random data of those shapes."""
    mods = sharded_modules(tsdxl.SDXLConfig(), TensorShard(0, tensor))
    with torch.device("meta"):
        whole = tsdxl.SDXLInpaintPipeline.build_modules(tsdxl.SDXLConfig())
    shapes = {k: tuple(v.shape) for k, v in whole["unet"].state_dict().items()}
    shards = {k: sdxl_shard("unet", k, s, 0, tensor) for k, s in shapes.items()}
    assert sum(1 for k, s in shards.items() if s is not None and k.endswith("kernel")) == kernels
    assert sum(1 for k, s in shards.items() if s is not None and k.endswith("bias")) == 70
    dense = {n: m for n, m in mods["unet"].named_modules() if isinstance(m, Dense)}
    for name, mod in dense.items():
        assert mod.shard == shards[f"{name}.kernel"], name
    # JAX's rule on the same paths (it reads only each leaf's ndim)
    tree = {}
    for k, shape in shapes.items():
        *path, leaf = k.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.zeros((0,) * len(shape))
    jax_sharded = {"/".join(p.key for p in path) for path, spec in
                   jax.tree_util.tree_flatten_with_path(tensor_parallel_pspecs(tree), is_leaf=lambda x: x is None)[0]
                   if any(a is not None for a in spec)}
    assert len(jax_sharded) == 700
    port_sharded = {k.replace(".", "/") for k, s in shards.items() if s is not None and k.endswith("kernel")}
    assert port_sharded <= jax_sharded and len(jax_sharded - port_sharded) == 700 - kernels
    if tensor == 2:
        rng = torch.Generator().manual_seed(0)
        picked = [k for k in shapes if shards[k] is not None][:40] + ["core.conv_in.kernel"]
        state = {"unet": {k: torch.randn(shapes[k], generator=rng) for k in picked}}
        parts = [shard_sdxl_state(state, r, tensor) for r in range(tensor)]
        back = unshard_sdxl_state(parts, {"unet": {k: shapes[k] for k in picked}})
        assert all(torch.equal(back["unet"][k], state["unet"][k]) for k in picked)


# ---------------------------------------------------------------------------
# (e) the generator, (f) the ranks' imports
# ---------------------------------------------------------------------------


def test_tp_generator_matches_one_rank(suite):
    """The dataset of a (data=1, tensor=2) mesh against one rank's: the
    same files and transforms.json; untouched PNGs equal, edited ones
    within the bound above; only rank 0 wrote (one view group)."""
    dp_root = Path(suite["ranks"][0]["dataset"])
    one_root = Path(suite["one"]["dataset"])
    assert suite["ranks"][1]["dataset"] == str(dp_root)
    one, tp = png_arrays(one_root), png_arrays(dp_root)
    assert sorted(one) == sorted(tp) and len(one) == 7 * 8 + 4
    for name in one:
        diff = np.abs(one[name] - tp[name])
        if name.startswith(EDITED):
            assert diff.max() <= GEN_MAX_LEVELS and diff.mean() <= GEN_MEAN_LEVELS, (name, diff.max(), diff.mean())
        else:
            assert diff.max() == 0, name
    t = json.loads((dp_root / "transforms.json").read_text())
    assert json.loads((one_root / "transforms.json").read_text()) == t
    assert t["reference_indices"] == [0, 1, 2] and t["generated_indices"] == [3, 4, 5, 6]


def test_no_jax_in_the_ranks(suite):
    for r, rank in enumerate(suite["ranks"]):
        assert rank["modules"] == [] and rank["backend"] == "gloo"
        assert rank["tensor"] == (TENSOR, r, 0, 1)  # (T, tensor rank, view group, view groups)
