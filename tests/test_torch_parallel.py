"""The port's data parallelism (signerf_tpu_torch/parallel/mesh.py) on the
CPU against the JAX package's data mesh and against the port's own one-rank
runs: `mesh_from_spec`'s grammar and refusals; four DP train steps of the
tiny `signerf_nerfacto` and `signerf` models on two ranks against JAX's
`shard_map` step (`make_train_step(mesh=get_mesh(2))` on the conftest's
CPU devices) and against one rank on the concatenated pixel indices; the
global batch's division and its refusals; the DP eval render against one
rank's (bit for bit) and JAX's meshed render; the generator's dealt chunks
against one rank's dataset; the train CLI on two ranks (self-spawned, the
viewer served by rank 0 and followed by rank 1, and the headless edit
flow); and no JAX in any rank.

Ranks are spawned processes (two gloo ranks on the CPU, one thread each, a
`file://` rendezvous under the test's tmp_path, every join under a
timeout); their work lives in tests/torch_parallel_helpers.py, which
imports torch and the port only. Pixel indices are fed to both packages,
rank r's (JAX: device r's) being row r of one table, and sampling is
deterministic on both sides, as in tests/test_torch_train.py.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.engine import optimizers as jopt
from signerf_tpu.engine import train_step as jts
from signerf_tpu.data.dataparser import SIGNeRFDataParserConfig as JParserCfg
from signerf_tpu.data.dataparser import parse_transforms as jparse
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu.models.nerfacto import NerfactoModelConfig as JCfg
from signerf_tpu.models.signerf import SIGNeRFModel as JSIGNeRFModel
from signerf_tpu.parallel import get_mesh, replicate
from signerf_tpu.parallel import mesh_from_spec as jmesh_from_spec
from signerf_tpu_torch.convert import lpips_from_jax, state_dict_from_jax
from signerf_tpu_torch.engine import train_step as tts
from signerf_tpu_torch.models import fields as tfields
from signerf_tpu_torch.models import nerfacto as tnerfacto
from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.parallel import mesh as mesh_lib
from signerf_tpu_torch.parallel.mesh import DataMesh, mesh_from_spec
from signerf_tpu_torch.utils.images import load_rgb
from tests import torch_parallel_helpers as hp
from tests.test_nerfacto_core import tiny_config
from tests.test_pipeline_e2e import H, N_CAMS, W, write_tiny_dataset
from tests.test_torch_edit_flow import GEN_CONFIG, assert_same_dataset, png_arrays, poses
from tests.test_torch_render import SMALL as RENDER_SMALL
from tests.test_torch_train import (
    GATE,
    NUM_CAMS,
    PATCH,
    DeterministicJaxModel,
    _model_flags,
    assert_runs_agree,
    faint_proposals,
    port_tiny_config,
    rel,
    scene,
    signerf_configs,
)

RANKS = 2
STEPS = 4
NUM_RAYS = 32  # 16 a rank
# The generator at 24 px (tests/test_torch_edit_flow.py's config at this size).
GEN_PX = 24
GEN_VIEWS = 4
GEN_BATCHES = (1, 2, 3)
RENDER_CHUNK = 16
RAGGED = 100  # 7 chunks on one rank; padded to 8 (4 a rank) on two


# ---------------------------------------------------------------------------
# (a) the spec grammar
# ---------------------------------------------------------------------------


def jax_shape(mesh):
    """A JAX mesh's (data, tensor) sizes (1 for an axis it lacks)."""
    return (mesh.shape.get("data", 1), mesh.shape.get("tensor", 1))


@pytest.mark.parametrize("spec", ["none", "off", "1", "false", "auto", None, "data", "data=2", "DATA=8",
                                  " data=4 "])
def test_mesh_spec_resolves_as_jax(spec):
    """Each spec resolves to the JAX mesh's (data, tensor) shape (None where
    JAX builds no mesh) on the conftest's 8 devices; `auto` is the data mesh."""
    want = jmesh_from_spec(spec)
    got = mesh_from_spec(spec, len(jax.devices()))
    assert got == (None if want is None else jax_shape(want))
    assert got is None or (got.size == want.size and got.tensor == 1)


def test_mesh_spec_on_one_device_and_on_the_cpu():
    assert mesh_from_spec("auto", 1) is None and mesh_from_spec(None, 1) is None
    assert mesh_from_spec("data", 1) == (1, 1) and mesh_from_spec("data=1", 1) == (1, 1)
    # the CPU: one process unless explicit sizes ask for more
    assert mesh_from_spec("auto", None) is None and mesh_from_spec("data", None) == (1, 1)
    assert mesh_from_spec("data=3", None) == (3, 1) and mesh_from_spec("tensor=2", None) == (1, 2)
    with pytest.raises(ValueError, match="not divisible by tensor=2"):
        mesh_from_spec("production", None)


@pytest.mark.parametrize("spec", ["production", "data=4,tensor=2", "tensor=2"])
def test_mesh_spec_refuses_the_tensor_axis(spec):
    """The tensor axis resolves as JAX builds it: production (4, 2) on the
    conftest's 8 devices, explicit sizes as given. JAX's tensor groups (the
    rows of its device array, reshape((n // T, T))) are runs of consecutive
    devices, as the port's tensor groups are runs of consecutive ranks."""
    want = jmesh_from_spec(spec)
    got = mesh_from_spec(spec, len(jax.devices()))
    assert got == jax_shape(want) and got.size == want.size and got.tensor == 2
    ids = np.array([d.id for d in np.asarray(want.devices).reshape(-1)]).reshape(-1, got.tensor)
    assert ids.tolist() == [[2 * g, 2 * g + 1] for g in range(got.data)]


@pytest.mark.parametrize("spec,devices", [("bogus", 8), ("data=9", 8), ("data=8,tensor=2", 8), ("tensor=16", 8),
                                          ("production", 7)])
def test_mesh_spec_refuses_bad_specs_as_jax(spec, devices):
    """What JAX refuses: an unknown spec, more devices than there are, and
    the production mesh on an odd count (JAX's `production_mesh(7)`)."""
    from signerf_tpu.parallel import production_mesh

    with pytest.raises(ValueError):
        if devices == len(jax.devices()):
            jmesh_from_spec(spec)
        else:
            production_mesh(devices)
    with pytest.raises(ValueError):
        mesh_from_spec(spec, devices)


def test_rank_seed_keeps_the_seed_on_rank_zero():
    assert mesh_lib.rank_seed(42, 0) == 42
    seeds = {mesh_lib.rank_seed(42, r) for r in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2**63 for s in seeds)
    assert mesh_lib.rank_seed(42, 1) == mesh_lib.rank_seed(42, 1) != mesh_lib.rank_seed(43, 1)


# ---------------------------------------------------------------------------
# (c) the global batch
# ---------------------------------------------------------------------------


class FakeMesh(DataMesh):
    """A rank of `world_size` for `make_train_step`'s arithmetic (no group)."""

    def __init__(self, world_size):
        super().__init__(rank=0, world_size=world_size, device=torch.device("cpu"), backend="gloo")


def settings_seen(monkeypatch, world, **settings):
    """The per-rank SamplerSettings `make_train_step` samples with."""
    seen = []
    monkeypatch.setattr(tts, "_sample_indices", lambda g, s, *a: seen.append(s) or torch.zeros((0, 3), dtype=torch.long))
    _, tcams, _, _ = scene()
    model = tnerfacto.NerfactoModel(port_tiny_config(), NUM_CAMS)
    fn = tts.make_train_step(model, None, tcams, tts.SamplerSettings(**settings), mesh=FakeMesh(world))
    with pytest.raises(Exception):
        fn(0, torch.zeros((NUM_CAMS, 16, 16, 3), dtype=torch.uint8), None, None)
    return seen[0]


@pytest.mark.parametrize("world,micro,want", [(2, 4, 2), (8, 4, 1), (4, 1, 1)])
def test_global_batch_divided_as_jax(monkeypatch, world, micro, want):
    """num_rays is the global batch (JAX tests/test_engine.py:287): each of
    W ranks samples num_rays / W in max(1, micro_batches / W) micro-batches,
    as JAX's `make_train_step(mesh=...)` replaces its settings."""
    s = settings_seen(monkeypatch, world, num_rays=1024, micro_batches=micro)
    assert (s.num_rays, s.micro_batches) == (1024 // world, want)


@pytest.mark.parametrize("world,settings", [
    (8, dict(num_rays=129)),  # 129 rays over 8 ranks
    (8, dict(num_rays=96, micro_batches=64)),  # 12 rays a rank in 8 micro-batches
    (2, dict(num_rays=2 * 256, patch_size=16, micro_batches=4)),  # half a 16x16 patch a micro-batch
])
def test_global_batch_refused_as_jax(world, settings):
    """A global batch that does not split over the ranks (JAX asserts,
    tests/test_engine.py:327), a rank's batch that does not split into its
    micro-batches, and micro-batches of part of a patch raise."""
    _, tcams, _, _ = scene()
    model = tnerfacto.NerfactoModel(port_tiny_config(), NUM_CAMS)
    with pytest.raises(ValueError):
        tts.make_train_step(model, None, tcams, tts.SamplerSettings(**settings), mesh=FakeMesh(world))


# ---------------------------------------------------------------------------
# the two-rank suite: (b) train, (d) render, (e) generate, (g) imports
# ---------------------------------------------------------------------------


def nerfacto_case():
    """The tiny model with a gated proposal step (tests/test_torch_train.py's
    `run_both`), fed 16 pixels a rank in one micro-batch each (2 globally)."""
    jcfg = dataclasses.replace(tiny_config(), **GATE)
    jmodel = JModel(jcfg, num_train_images=NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    faint_proposals(params)
    jcams, _, images, idx = scene()
    case = dict(signerf=False, config=port_tiny_config(jcfg, **GATE), num_images=NUM_CAMS,
                state=state_dict_from_jax(params), table=idx.reshape(RANKS, -1, 3),
                settings=dict(num_rays=NUM_RAYS, micro_batches=RANKS), steps=STEPS, **scene_arrays(images))
    return jmodel, params, jcams, case


def signerf_case():
    """The tiny `signerf` model (normals, L1, LPIPS) with 16x16 patches: one
    whole patch (one camera's image) a rank."""
    jcfg, tcfg = signerf_configs(False)
    jmodel = JSIGNeRFModel(jcfg, num_train_images=NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    faint_proposals(params)
    jcams, _, images, _ = scene()
    yy, xx = np.meshgrid(np.arange(PATCH), np.arange(PATCH), indexing="ij")
    idx = np.concatenate([np.stack([np.full_like(yy, c), yy, xx], -1).reshape(-1, 3) for c in range(NUM_CAMS)])
    case = dict(signerf=True, config=tcfg, num_images=NUM_CAMS, state=state_dict_from_jax(params),
                lpips=lpips_from_jax(jmodel.lpips_params), table=idx.astype(np.int32).reshape(RANKS, -1, 3),
                settings=dict(num_rays=len(idx), patch_size=PATCH, micro_batches=RANKS), steps=STEPS,
                **scene_arrays(images))
    return jmodel, params, jcams, case


def scene_arrays(images):
    jcams, tcams, _, _ = scene()
    return dict(c2w=tcams.camera_to_worlds.numpy(), hw=(tcams.height, tcams.width), images=images,
                intr={k: getattr(tcams, k).numpy() for k in ("fx", "fy", "cx", "cy")})


def render_case(data: Path):
    """tests/test_torch_render.py's eval-render parity setup: its small
    model at PRNGKey(1) and camera 0 of its 24 px dataset (576 rays, 36
    chunks of 16, 18 a rank)."""
    jmodel = JModel(JCfg(**RENDER_SMALL), num_train_images=N_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(1)))
    out = jparse(JParserCfg(data=data))
    cams = jax.tree_util.tree_map(jnp.asarray, out.cameras)
    rb = cams.generate_rays(camera_index=0, aabb=jnp.asarray(out.scene_box_aabb)).reshape((-1,))
    rays = {k: np.array(getattr(rb, k)) for k in ("origins", "directions", "pixel_area", "camera_indices", "nears",
                                                  "fars")}
    case = dict(config=NerfactoModelConfig(**RENDER_SMALL), num_images=N_CAMS, state=state_dict_from_jax(params),
                rays=rays, chunk=RENDER_CHUNK, ragged=RAGGED)
    return jmodel, params, rb, case


def generate_case(path: Path, batch: int):
    cfg = dict(GEN_CONFIG, width=GEN_PX, height=GEN_PX, cx=GEN_PX / 2, cy=GEN_PX / 2, fx=30.0, fy=30.0,
               generation_batch_size=batch)
    return dict(path=str(path), config=cfg, references=poses(3, 60.0, 240.0), views=poses(GEN_VIEWS, 75.0, 288.0))


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Every case on two spawned gloo ranks, once: the cases and each rank's
    results."""
    tmp = tmp_path_factory.mktemp("dp")
    nerfacto, signerf = nerfacto_case(), signerf_case()
    render = render_case(write_tiny_dataset(tmp / "data"))
    cases = {"nerfacto": ("train", nerfacto[3]), "signerf": ("train", signerf[3]), "render": ("render", render[3])}
    for b in GEN_BATCHES:
        cases[f"generate{b}"] = ("generate", generate_case(tmp / "ranks" / f"b{b}", b))
    hp.spawn(hp.suite, (cases, str(tmp)), RANKS, tmp)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {"tmp": tmp, "cases": cases, "ranks": ranks, "nerfacto": nerfacto, "signerf": signerf, "render": render}


@pytest.fixture
def xla_routes(monkeypatch):
    """The ranks' density and normals routes in this process (hp.xla_routes)."""
    monkeypatch.setattr(tfields, "fused_density_mlp", tfg.density_mlp_reference)
    monkeypatch.setattr(tnerfacto, "factor_density_geo_and_grad",
                        functools.partial(tfields.factor_density_geo_and_grad, xla=True))


def jax_dp_run(monkeypatch, jmodel, params, jcams, case):
    """JAX's `shard_map` step on 2 of the conftest's devices, device r fed
    row r of the table: each step's metrics and the last params."""
    table = jnp.asarray(case["table"])
    monkeypatch.setattr(jts, "_sample_indices", lambda *a, **k: table[jax.lax.axis_index("data")])
    mesh = get_mesh(RANKS)
    jo = jopt.make_optimizer(jopt.OptimizersConfig(), params)
    jfn = jts.make_train_step(DeterministicJaxModel(jmodel), jo, jcams, jts.SamplerSettings(**case["settings"]),
                              mesh=mesh, donate=False)
    state = replicate(jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jo), mesh)
    images = replicate(jnp.asarray(case["images"]), mesh)
    metrics = []
    for _ in range(case["steps"]):
        state, m = jfn(state, images, None, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))


def jax_full_batch_grads(jmodel, params, jcams, case):
    """The first step's gradients of the loss over all ranks' pixels (the
    DP average of per-rank mean losses, equal halves)."""
    idx = jnp.asarray(np.asarray(case["table"]).reshape(-1, 3))
    target = jnp.asarray(case["images"])[idx[:, 0], idx[:, 1], idx[:, 2]].astype(jnp.float32) / 255.0

    def loss(p):
        out = jmodel.apply(p, jcams.generate_rays_at(idx), rng=None, train=True, anneal=jmodel.anneal(0))
        return sum(jax.tree_util.tree_leaves(jmodel.loss_dict(out, {"image": target})))

    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))


def test_ranks_hold_equal_parameters(suite):
    """Every rank's parameters and first-step gradients after the DP steps
    are the same tensors, bit for bit; so are its metrics."""
    r0, r1 = suite["ranks"]
    for name in ("nerfacto", "signerf"):
        assert r0[name]["metrics"] == r1[name]["metrics"], name
        for part in ("params", "grads"):
            diff = max(float((r0[name][part][k] - r1[name][part][k]).abs().max()) for k in r0[name][part])
            assert diff == 0.0, (name, part, diff)


@pytest.mark.parametrize("name", ["nerfacto", "signerf"])
def test_dp_train_equals_one_rank_on_the_concatenated_batch(suite, xla_routes, monkeypatch, name):
    """The port's one-rank step on both ranks' pixels in order, in as many
    micro-batches as ranks, averages the same per-rank gradients: measured
    equal bit for bit (a sum of two f32 terms halved, in either order)."""
    monkeypatch.setattr(tts, "_sample_indices", tts._sample_indices)  # hp.train_case feeds its own; restored after
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' threads: CPU reductions split by thread
    try:
        one = hp.train_case(None, suite["cases"][name][1])
    finally:
        torch.set_num_threads(threads)
    dp = suite["ranks"][0][name]
    assert one["metrics"] == dp["metrics"]
    for part in ("params", "grads"):
        for k in one[part]:
            assert torch.equal(one[part][k], dp[part][k]), (part, k)


def test_dp_nerfacto_matches_jax_shard_map(suite, monkeypatch):
    """Four DP steps against JAX's DP step, by `assert_runs_agree` of
    tests/test_torch_train.py: metrics rtol 1e-2, first-step gradients
    (against JAX's on the whole batch) per leaf 0.05 norm-relative, the
    last params per leaf 0.1 and the whole update 0.2."""
    jmodel, params, jcams, case = suite["nerfacto"]
    jm, jp = jax_dp_run(monkeypatch, jmodel, params, jcams, case)
    jg = jax_full_batch_grads(jmodel, params, jcams, case)
    dp = suite["ranks"][0]["nerfacto"]
    assert_runs_agree(jm, dp["metrics"], jp, dp["params"], jg, dp["grads"], case["state"])


def test_dp_signerf_matches_jax_shard_map(suite, monkeypatch):
    """Four DP `signerf` steps (a patch a rank) against JAX's DP step, at
    tests/test_torch_train.py's `signerf` tolerances: metrics rtol 1e-2
    (the orientation loss 0.05), first-step gradients per leaf 0.05
    norm-relative; and the last params per leaf within 0.1 norm-relative,
    run_both's bound."""
    jmodel, params, jcams, case = suite["signerf"]
    jm, jp = jax_dp_run(monkeypatch, jmodel, params, jcams, case)
    jg = jax_full_batch_grads(jmodel, params, jcams, case)
    dp = suite["ranks"][0]["signerf"]
    for a, b in zip(jm, dp["metrics"]):
        assert sorted(a) == sorted(b)
        for k in a:
            rtol = 0.05 if k == "orientation_loss" else 1e-2
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-12, err_msg=k)
    for k in jg:
        assert rel(dp["grads"][k], jg[k]) < 0.05, (k, rel(dp["grads"][k], jg[k]))
    for k in jp:
        assert rel(dp["params"][k], jp[k]) < 0.1, (k, rel(dp["params"][k], jp[k]))


def test_dp_render_equals_one_rank_bit_for_bit(suite, xla_routes):
    one = hp.render_case(None, suite["cases"]["render"][1])
    dp = suite["ranks"][0]["render"]
    assert sorted(one) == sorted(dp)
    for k in one:
        assert one[k].dtype == dp[k].dtype and np.array_equal(one[k], dp[k]), k
    assert dp["rgb"].shape == (H * W, 3) and dp["ragged_rgb"].shape == (RAGGED, 3)
    assert np.array_equal(suite["ranks"][1]["render"]["rgb"], dp["rgb"])


def test_dp_render_matches_jax_meshed_render(suite):
    """Against JAX's `make_eval_render(mesh=get_mesh(2))` (tests/test_engine.py:357)
    at tests/test_torch_render.py's tolerances: 0.02 on rgb and
    accumulation, 2% of the depth range on the expected depth, 95% of the
    median depths within 1e-3."""
    jmodel, params, rb, _ = suite["render"]
    render = jts.make_eval_render(jmodel, chunk_size=RENDER_CHUNK, mesh=get_mesh(RANKS))
    want = {k: np.asarray(v) for k, v in render(params, rb).items()}
    got = suite["ranks"][0]["render"]
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(got[k], want[k], atol=0.02, err_msg=k)
    depth_range = float(want["expected_depth"].max() - want["expected_depth"].min())
    np.testing.assert_allclose(got["expected_depth"], want["expected_depth"], atol=0.02 * max(depth_range, 1e-3))
    assert np.isclose(got["depth"], want["depth"], rtol=1e-3, atol=1e-4).mean() >= 0.95


@pytest.mark.parametrize("batch", GEN_BATCHES)
def test_dp_generator_equals_one_rank(suite, batch):
    """The chunks dealt round-robin over two ranks (batch 1: views 0 and 2
    on rank 0; 3: three views on rank 0, one on rank 1) give one rank's
    dataset: every PNG equal, by `assert_same_dataset` and bit for bit."""
    kind, case = suite["cases"][f"generate{batch}"]
    dp_root = Path(suite["ranks"][0][f"generate{batch}"])
    assert suite["ranks"][1][f"generate{batch}"] == str(dp_root)
    one_root = Path(hp.generate_case(None, dict(case, path=str(suite["tmp"] / "one" / f"b{batch}"))))
    assert_same_dataset(one_root, dp_root)
    one, dp = png_arrays(one_root), png_arrays(dp_root)
    assert sorted(one) == sorted(dp) and all(np.array_equal(one[k], dp[k]) for k in one)
    t = json.loads((dp_root / "transforms.json").read_text())
    assert t["reference_indices"] == [0, 1, 2] and t["generated_indices"] == list(range(3, 3 + GEN_VIEWS))
    assert json.loads((one_root / "transforms.json").read_text()) == t
    edited = load_rgb(dp_root / "images" / "image_4.png")
    assert ((edited[..., 1] > 200) & (edited[..., 0] < 100)).sum() > 0  # the edit landed


def test_no_jax_in_the_ranks(suite):
    for rank in suite["ranks"]:
        assert rank["modules"] == [] and rank["backend"] == "gloo" and rank["world_size"] == RANKS


def test_rendezvous_in_a_directory_a_uri_would_quote(tmp_path):
    """A run's output directory may hold spaces or parentheses: the file
    rendezvous under it still forms a group (a quoted URI names a file that
    does not exist), and leaves no file behind."""
    from signerf_tpu_torch.parallel.mesh import init_mesh, rendezvous

    where = tmp_path / "out (run 1)"
    init = rendezvous(where)
    mesh = init_mesh(0, 1, init, torch.device("cpu"), timeout_s=30)
    try:
        assert mesh.broadcast_object({"word": 1}) == {"word": 1}
    finally:
        mesh.close()
    Path(init.removeprefix("file://")).unlink(missing_ok=True)  # as `spawn` and `run` do
    assert list(where.iterdir()) == []


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """One rank raising ends the other, which waits for it at a barrier,
    and the spawner raises, long before the group's timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        hp.spawn(hp.failing_rank, (), RANKS, tmp_path)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# (f) the train CLI on two ranks
# ---------------------------------------------------------------------------

CLI_EDIT = [
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
    "--pipeline.dataset-generator.rows", "2", "--pipeline.dataset-generator.cols", "2",
    "--pipeline.dataset-generator.aabb-min", "[5.0, 5.0, 5.0]",
    "--pipeline.dataset-generator.aabb-max", "[6.0, 6.0, 6.0]",
    "--pipeline.dataset-generator.inverse-mask", "True",
    "--pipeline.dataset-generator.mask-dilation", "[3, 3]",
    "--pipeline.dataset-generator.diffuser.mode", "custom",
]


@pytest.mark.parametrize("spec", ["data", "data=2"])
def test_train_cli_spawns_its_ranks(tmp_path, monkeypatch, spec):
    """Without a launcher, `--mesh data` on the CPU is a group of one in
    this process, and `--mesh data=2` spawns two gloo ranks; rank 0 alone
    writes the config, the events (one row a logged step, not two) and the
    checkpoints."""
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.engine.checkpoints import load_checkpoint

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    rc = train_cli.main(["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
                         "--mesh", spec, "--max-num-iterations", "8", "--steps-per-call", "2",
                         "--steps-per-save", "4", "--output-dir", str(out),
                         "--pipeline.datamanager.train-num-rays-per-batch", "64", *_model_flags("pipeline.model.")])
    assert rc == 0
    run = out / "experiment" / "signerf_nerfacto"
    assert sorted(p.name for p in (run / "checkpoints").glob("step-*.pt")) == [
        "step-000000004.pt", "step-000000008.pt"]
    assert load_checkpoint(run / "checkpoints" / "step-000000008.pt")["step"] == 8
    rows = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [8]  # every fourth call of 2 steps
    assert not list(out.glob(".rendezvous-*"))


def test_train_cli_refuses_the_viewer_on_two_ranks(tmp_path):
    """Without --train-only or --skip-interface, `train._run` on two ranks
    reaches `run_interface` on both: rank 0 serves (a client there reads
    /state, then closes the viewer), rank 1 serves nothing and follows rank
    0's control words until the close. (Before the viewer ran on a mesh,
    this refused it.)"""
    from tests import torch_interface_ranks_helpers as ih

    data = write_tiny_dataset(tmp_path / "data")
    argv = ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--mesh", "data=2", "--output-dir",
            str(tmp_path / "out"), *_model_flags("pipeline.model."), *CLI_EDIT]
    hp.spawn(ih.cli_viewer, (argv, str(tmp_path)), RANKS, tmp_path)
    r0, r1 = (torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False) for r in range(RANKS))
    assert r0["reached"] == r1["reached"] == 1 and r0["rc"] == r1["rc"] == 0
    assert len(r0["served"]) == 1 and r1["served"] == [] and r0["words"] == r1["words"] >= 1
    assert r0["client"] == {"state": {"training_state": "paused", "step": 0, "metrics": {}}, "world": RANKS}
    assert r0["modules"] == r1["modules"] == []


def test_headless_cli_on_two_ranks_lands_the_edit(tmp_path):
    """The headless edit flow (`--skip-interface True`) on two ranks from a
    100-step one-rank checkpoint: the dealt generation, the exchange (rank
    0's checkpoint read after the barrier), 200 DP refinement steps of 32
    rays a rank; the edit lands in the NeRF; only rank 0 wrote checkpoints
    (two, not four); both ranks end with equal parameters."""
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager
    from signerf_tpu_torch.engine.checkpoints import surgical_restore
    from signerf_tpu_torch.pipeline import SURGERY_SEED, seeded_model
    from tests.test_pipeline_e2e import EDIT_COLOR, EDIT_HI, EDIT_LO

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    # tests/test_torch_edit_flow_cli.py's tiny_trainer_config planes and background
    base = ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--steps-per-call", "25",
            "--output-dir", str(out), *_model_flags("pipeline.model."), *CLI_EDIT,
            "--pipeline.model.background-color", "black", "--pipeline.model.near-plane", "0.5",
            "--pipeline.model.far-plane", "8.0"]
    assert train_cli.main([*base, "--train-only", "True", "--max-num-iterations", "100",
                           "--experiment-name", "pre"]) == 0
    ckpt_dir = out / "pre" / "signerf_nerfacto" / "checkpoints"
    prev = tmp_path / "prev"
    prev.mkdir()
    ring = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()
    frames = [{"file_path": f"./images/image_{i}.png", "transform_matrix": p.tolist()} for i, p in enumerate(ring)]
    (prev / "transforms.json").write_text(json.dumps({"frames": frames, "reference_indices": [0, 1, 2]}))
    argv = [*base, "--skip-interface", "True", "--load-dir", str(ckpt_dir), "--previous-experiment-dir",
            str(prev), "--max-num-iterations", "200", "--steps-per-save", "200", "--experiment-name", "edit",
            "--pipeline.dataset-generator.path", str(tmp_path / "gen")]
    hp.spawn(hp.train_cli, (argv, str(tmp_path)), RANKS, tmp_path)
    r0, r1 = (torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False) for r in range(RANKS))
    assert r0["step"] == r1["step"] == 200 and r0["modules"] == r1["modules"] == []
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    ckpts = sorted((out / "edit" / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    assert [p.name for p in ckpts] == ["step-000000000.pt", "step-000000200.pt"]
    gen = tmp_path / "gen" / "experiment"
    t = json.loads((gen / "transforms.json").read_text())
    assert t["generated_indices"] == list(range(3, 3 + N_CAMS))
    assert len(list((gen / "images").glob("*.png"))) == 3 + N_CAMS

    # the edit lands: view 0 of the generated ring, before the refinement
    # (the exchange's reload of rank 0's checkpoint) and after it
    mcfg = train_cli.parse(argv)[2]
    mcfg.pipeline.datamanager.dataparser.data = gen
    dm = SIGNeRFDataManager(mcfg.pipeline.datamanager, "cpu")
    view = t["generated_indices"][0]
    box = (slice(EDIT_LO, EDIT_HI), slice(EDIT_LO, EDIT_HI))

    def box_error(state) -> float:
        model = seeded_model(mcfg.pipeline.model, dm.num_images, SURGERY_SEED)
        model.load_state_dict(state, strict=True)
        h, w = dm.cameras.height, dm.cameras.width
        aabb = torch.as_tensor(dm.outputs.scene_box_aabb)
        rb = dm.cameras.generate_rays(camera_index=view, aabb=aabb).reshape((h * w,))
        rgb = tts.make_eval_render(model.eval(), chunk_size=256)(rb, appearance_mode="index")["rgb"]
        return float(np.abs(rgb.reshape(h, w, 3).numpy()[box] - EDIT_COLOR).mean())

    fresh = seeded_model(mcfg.pipeline.model, dm.num_images, SURGERY_SEED).state_dict()
    pre = box_error(surgical_restore(ckpts[0], fresh, drop_proposals=True))
    post = box_error(r0["params"])
    assert post < pre - 0.05, f"the edit did not land: {pre:.3f} -> {post:.3f}"


def test_north_star_pass_on_two_ranks(tmp_path):
    """examples/north_star_pass_torch.py's `main` as two ranks (`mesh=`), at
    2 views of 32 px with a narrowed model, 2 pretrain and 2 refinement
    steps: rank 0 returns the one-rank result's keys with "cards": 2, the
    others an empty result; the dataset holds every view."""
    out = tmp_path / "ns"
    argv = ["2", "2", "2", "--device", "cpu", "--size", "32", "--out", str(out)]
    hp.spawn(hp.north_star, (argv, str(tmp_path)), RANKS, tmp_path)
    r0, r1 = (torch.load(tmp_path / f"ns_rank{r}.pt", weights_only=False) for r in range(RANKS))
    assert r1["result"] == {} and r0["modules"] == r1["modules"] == []
    result = r0["result"]
    assert result["cards"] == RANKS and result["hardware"] == "CPU, 2 ranks"
    assert json.loads((out / "north_star_result_torch.json").read_text()) == result
    assert result["n_views"] == 2 and result["refine_steps"] == 2 and result["edit_mask_coverage"] >= 0
    meta = json.loads((out / "generations" / "edit0" / "transforms.json").read_text())
    assert len(meta["frames"]) == 8 + 2 and meta["generated_indices"] == [8, 9]
