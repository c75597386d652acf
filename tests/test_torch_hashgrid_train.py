"""Training with the hash-grid backend against the JAX package, and the
port's CLIs with `encoding_backend="hash"` on the CPU.

Train steps: tests/test_torch_train.py's deterministic scene and gated
schedule (fixed pixel indices, no jitter), tiny_config with the backend
swapped, four steps of JAX's `make_train_step` and of the port's from the
same params, without and with the gradient normals (second order through
the hash encode). CLIs: train (`signerf_nerfacto` and `signerf`), render,
eval, both export subcommands and the headless edit flow with the hash
override at a tiny size; `config.yml` round-trips.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.engine import optimizers as jopt
from signerf_tpu.engine import train_step as jts
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.engine import checkpoints as tck
from signerf_tpu_torch.engine import optimizers as topt
from signerf_tpu_torch.engine import train_step as tts
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainerConfig
from signerf_tpu_torch.models.nerfacto import NerfactoModel
from tests.test_pipeline_e2e import N_CAMS, write_tiny_dataset
from tests.test_torch_hashgrid import jax_hash_config, port_hash_config
from tests.test_torch_train import GATE, NUM_CAMS, NUM_RAYS, DeterministicJaxModel, faint_proposals, rel, scene

torch.set_num_threads(2)

STEPS = 4


def run_both(monkeypatch, normals: bool):
    """STEPS steps of both train steps from the same params and indices ->
    (jax metrics, port metrics, jax params, port params, initial params),
    params as the port's flat names."""
    knobs = dict(predict_normals=normals, **GATE)
    jmodel = JModel(jax_hash_config(**knobs), num_train_images=NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    faint_proposals(params)
    jcams, tcams, images, idx = scene()
    settings = dict(num_rays=NUM_RAYS)

    monkeypatch.setattr(jts, "_sample_indices", lambda *a, **k: jnp.asarray(idx))
    jo = jopt.make_optimizer(jopt.OptimizersConfig(), params)
    jfn = jts.make_train_step(DeterministicJaxModel(jmodel), jo, jcams, jts.SamplerSettings(**settings),
                              donate=False)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jo)
    jmetrics = []
    for _ in range(STEPS):
        state, m = jfn(state, jnp.asarray(images), None, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    monkeypatch.setattr(tts, "_sample_indices", lambda *a, **k: torch.from_numpy(idx))
    model = NerfactoModel(port_hash_config(**knobs), NUM_CAMS)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    to = topt.make_optimizer(topt.OptimizersConfig(), model)
    tfn = tts.make_train_step(model, to, tcams, tts.SamplerSettings(**settings))
    tmetrics = [{k: float(v) for k, v in tfn(step, torch.from_numpy(images), None, None).items()}
                for step in range(STEPS)]
    jparams = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    return jmetrics, tmetrics, jparams, model.state_dict(), state_dict_from_jax(params)


@pytest.mark.parametrize("normals", [False, True], ids=["plain", "gradient_normals"])
def test_hash_train_step_matches_jax(monkeypatch, normals):
    """Four steps (a gated proposal step among them) against JAX's
    `make_train_step`: the metrics within 1e-2 relative and the parameters
    per leaf as the factor backend's test compares them (Adam with eps =
    1e-15 moves an element with a rounding-noise gradient by +-lr, so
    leaves are compared by norm-relative error, and the whole update over
    all leaves); the hash tables move, and rows no sample touched stay."""
    jm, tm, jp, tp, p0 = run_both(monkeypatch, normals)
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)
        for k in a:
            # the orientation loss is a 1e-5 penalty fed by normals that
            # face away from the camera, which the +-lr moves shift most
            rtol = 0.05 if k == "orientation_loss" else 1e-2
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-6, err_msg=k)
    for k in jp:
        # measured under 0.09 (the base table with the gradient normals),
        # except the pred-normal head's biases: they start at 0 and their
        # target, the detached gradient normals, differs by the bf16 order
        # of its derivative (0.3%), so a near-0 element steps +-lr the other
        # way (measured 0.108 and 0.113)
        bound = 0.2 if k.startswith("field.mlp_pred_normals.") and k.endswith("bias") else 0.1
        assert rel(tp[k], jp[k]) < bound, (k, rel(tp[k], jp[k]))
    upd_t = torch.cat([(tp[k] - p0[k]).flatten() for k in jp])
    upd_j = torch.cat([(jp[k] - p0[k]).flatten() for k in jp])
    assert rel(upd_t, upd_j) < 0.2, rel(upd_t, upd_j)
    for k in ("field.encoding.table", "proposal_0.HashGridEncoding_0.table"):
        moved_t = (tp[k] - p0[k]).ne(0)
        assert bool(moved_t.any()), k
        # the same rows move in both packages: a row no corner of any
        # sample hashes to has a zero gradient, and Adam leaves it put
        assert torch.equal(moved_t.any(-1), (jp[k] - p0[k]).ne(0).any(-1)), k


# ---------------------------------------------------------------------------
# the CLIs with the hash override
# ---------------------------------------------------------------------------

PROPOSALS = json.dumps([
    {"hidden_dim": 8, "num_levels": 2, "max_res": 32, "log2_hashmap_size": 6},
    {"hidden_dim": 8, "num_levels": 2, "max_res": 64, "log2_hashmap_size": 6},
])
HASH_MODEL = [
    "--encoding-backend", "hash", "--num-levels", "4", "--log2-hashmap-size", "8", "--max-res", "64",
    "--hidden-dim", "8", "--hidden-dim-color", "8", "--num-proposal-samples-per-ray", "[8, 6]",
    "--num-nerf-samples-per-ray", "4", "--proposal-net-args-list", PROPOSALS,
]


def hash_flags(prefix: str):
    return [f"--{prefix}{a[2:]}" if a.startswith("--") else a for a in HASH_MODEL]


def table_shapes(params):
    return {k: tuple(v.shape) for k, v in params.items() if k.endswith(".table")}


HASH_TABLES = {"field.encoding.table": (4, 256, 2), "proposal_0.HashGridEncoding_0.table": (2, 64, 2),
               "proposal_1.HashGridEncoding_0.table": (2, 64, 2)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from signerf_tpu_torch import train as train_cli

    tmp = tmp_path_factory.mktemp("hash_cli")
    data = write_tiny_dataset(tmp / "data")
    out = tmp / "out"
    assert train_cli.main(
        ["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
         "--max-num-iterations", "4", "--steps-per-call", "2", "--steps-per-save", "4",
         "--output-dir", str(out), "--pipeline.datamanager.train-num-rays-per-batch", "64",
         *hash_flags("pipeline.model.")]
    ) == 0
    return tmp, data, out / "experiment" / "signerf_nerfacto"


def test_train_cli_hash_checkpoint_and_config(trained):
    """The override reaches both fields: the checkpoint holds the hash
    tables under the JAX names (and no factor lines), the tables trained,
    and config.yml loads back to the same config."""
    _, _, run = trained
    ckpt = tck.load_checkpoint(run / "checkpoints" / "step-000000004.pt")
    assert table_shapes(ckpt["params"]) == HASH_TABLES
    assert not any(".line_" in k for k in ckpt["params"])
    assert float(ckpt["params"]["field.encoding.table"].abs().max()) > 1e-4  # moved off the init's range
    cfg = cfglib.load_yaml(SIGNeRFTrainerConfig, run / "config.yml")
    model = cfg.pipeline.model
    assert (model.encoding_backend, model.num_levels, model.log2_hashmap_size) == ("hash", 4, 8)
    assert [a.log2_hashmap_size for a in model.proposal_net_args_list] == [6, 6]
    assert cfglib.to_yaml(cfg) == (run / "config.yml").read_text()


def test_render_eval_export_clis_with_hash(trained):
    from signerf_tpu_torch import eval as eval_cli
    from signerf_tpu_torch import export
    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch.geometry.obj import load_obj

    tmp, data, run = trained
    ckpt_dir = run / "checkpoints"
    model = hash_flags("model.")
    assert render_cli.main(["--data", str(data), "--output", str(tmp / "r"), "--load-dir", str(ckpt_dir),
                            "--device", "cpu", "--depth", "false", *model]) == 0
    assert len(list((tmp / "r").glob("rgb_*.png"))) == N_CAMS
    assert eval_cli.main(["--data", str(data), "--output", str(tmp / "e.json"), "--load-dir", str(ckpt_dir),
                          "--device", "cpu", *model]) == 0
    summary = json.loads((tmp / "e.json").read_text())
    assert summary["num_images"] == N_CAMS and np.isfinite(summary["psnr"])
    assert export.main(["pointcloud", "--data", str(data), "--load-dir", str(ckpt_dir), "--output",
                        str(tmp / "pc.ply"), "--downscale", "2", "--min-accumulation", "0.0", "--num-points", "200",
                        "--device", "cpu", *model]) == 0
    assert 0 < export.read_ply_header(tmp / "pc.ply") <= 200
    assert export.main(["mesh", "--data", str(data), "--load-dir", str(ckpt_dir), "--output", str(tmp / "m.obj"),
                        "--resolution", "16", "--iso", "p50", "--device", "cpu", *model]) == 0
    verts, faces = load_obj(tmp / "m.obj")
    assert len(verts) > 0 and len(faces) > 0
    # a factor model of the default widths refuses the hash checkpoint
    with pytest.raises(RuntimeError, match="loading state_dict"):
        render_cli.main(["--data", str(data), "--output", str(tmp / "r2"), "--load-dir", str(ckpt_dir),
                         "--device", "cpu"])


def test_signerf_train_cli_with_hash(tmp_path):
    """The `signerf` method (normals through autograd, both normals losses,
    L1 + random LPIPS) with the hash override: two steps, finite, and the
    checkpoint's tables and pred-normal head."""
    from signerf_tpu_torch import train as train_cli

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        assert train_cli.main(
            ["signerf", "--data", str(data), "--train-only", "True", "--device", "cpu",
             "--max-num-iterations", "2", "--steps-per-call", "2", "--steps-per-save", "2",
             "--output-dir", str(out), "--pipeline.datamanager.train-num-rays-per-batch", "512",
             "--pipeline.datamanager.patch-size", "16", "--pipeline.model.patch-size", "16",
             *hash_flags("pipeline.model.")]
        ) == 0
    params = tck.load_checkpoint(out / "experiment" / "signerf" / "checkpoints" / "step-000000002.pt")["params"]
    assert table_shapes(params) == HASH_TABLES
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    assert any(k.startswith("field.mlp_pred_normals.") for k in params)


def test_headless_edit_flow_with_hash(tmp_path):
    """`--skip-interface True` with the hash override: generate with the
    fake diffuser, hot-swap, refine; the exchange reloads the hash
    checkpoint without its proposal tables."""
    from signerf_tpu_torch import pipeline as tpipe
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.cameras.poses import circle_poses
    from tests.test_torch_edit_flow_cli import CLI_EDIT, FakeDiffuser

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    base = ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--steps-per-call", "2",
            "--output-dir", str(out), *hash_flags("pipeline.model."), *CLI_EDIT]
    assert train_cli.main([*base, "--train-only", "True", "--max-num-iterations", "2",
                           "--experiment-name", "pre"]) == 0
    prev = tmp_path / "prev"
    prev.mkdir()
    poses = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()
    frames = [{"file_path": f"./images/image_{i}.png", "transform_matrix": p.tolist()} for i, p in enumerate(poses)]
    (prev / "transforms.json").write_text(json.dumps({"frames": frames, "reference_indices": [0, 1, 2]}))
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "Diffuser", FakeDiffuser)
    try:
        assert train_cli.main([*base, "--skip-interface", "True", "--load-dir",
                               str(out / "pre" / "signerf_nerfacto" / "checkpoints"),
                               "--previous-experiment-dir", str(prev), "--max-num-iterations", "2",
                               "--experiment-name", "edit", "--pipeline.dataset-generator.path",
                               str(tmp_path / "gen")]) == 0
    finally:
        mp.undo()
    t = json.loads((tmp_path / "gen" / "experiment" / "transforms.json").read_text())
    assert t["reference_indices"] == [0, 1, 2] and len(t["generated_indices"]) == N_CAMS
    ckpts = sorted((out / "edit" / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    assert [p.name for p in ckpts] == ["step-000000000.pt", "step-000000002.pt"]
    assert table_shapes(tck.load_checkpoint(ckpts[-1])["params"]) == HASH_TABLES
