"""The port's render slice against the JAX package: the eval renderer with
converted JAX params, the render CLI, `--load-dir`, the converter, and the
no-JAX import rule.

Small model, as tests/test_render_cli.py drives the JAX CLI: max_res 32,
hidden 8, samples [8, 6] / 4, on the tiny 24x24 dataset of
tests/test_pipeline_e2e.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.data.dataparser import SIGNeRFDataParserConfig as JParserCfg
from signerf_tpu.data.dataparser import parse_transforms as jparse
from signerf_tpu.engine.train_step import make_eval_render as jmake_eval_render
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu.models.nerfacto import NerfactoModelConfig as JCfg
from signerf_tpu_torch.cameras.cameras import RayBundle
from signerf_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from signerf_tpu_torch.render import main as render_main
from signerf_tpu_torch.render import render_cameras
from tests.test_pipeline_e2e import H, N_CAMS, W, write_tiny_dataset

torch.set_num_threads(2)

SMALL = dict(
    max_res=32,
    hidden_dim=8,
    hidden_dim_color=8,
    num_proposal_samples_per_ray=(8, 6),
    num_nerf_samples_per_ray=4,
)
SMALL_FLAGS = [
    "--model.max-res", "32",
    "--model.hidden-dim", "8",
    "--model.hidden-dim-color", "8",
    "--model.num-proposal-samples-per-ray", "[8, 6]",
    "--model.num-nerf-samples-per-ray", "4",
]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_tiny_dataset(tmp_path_factory.mktemp("torch_render") / "data")


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = JModel(JCfg(**SMALL), num_train_images=N_CAMS)
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    return model, jax.tree_util.tree_map(np.asarray, params)


def port_model(np_params):
    model = NerfactoModel(NerfactoModelConfig(**SMALL), num_train_images=N_CAMS)
    model.load_state_dict(state_dict_from_jax(np_params), strict=True)
    return model.eval()


def test_converter_round_trip(jax_model_and_params):
    _, params = jax_model_and_params
    sd = state_dict_from_jax(params)
    model = NerfactoModel(NerfactoModelConfig(**SMALL), num_train_images=N_CAMS)
    own = model.state_dict()
    assert sorted(sd) == sorted(own)  # names and count match the port's modules
    for k, v in sd.items():
        assert v.shape == own[k].shape and v.dtype == torch.float32, k
    back = jax_params_from_state_dict(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert "field.mlp_base.dense_0.kernel" in sd and "proposal_1.MLP_0.dense_1.bias" in sd
    assert sd["field.mlp_base.dense_0.kernel"].shape == (128, 8)  # flax [in, out], kept


def test_seeded_init_matches_jax_layout():
    cfg = NerfactoModelConfig(**SMALL)
    a = NerfactoModel(cfg, N_CAMS).reset_parameters(torch.Generator().manual_seed(0))
    b = NerfactoModel(cfg, N_CAMS).reset_parameters(torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert torch.count_nonzero(sd["field.mlp_base.dense_0.bias"]) == 0
    assert 0.15 < float(sd["field.encoding.line_7_2"].std()) < 0.25  # N(0, 0.2)
    k = sd["field.mlp_head.dense_0.kernel"]
    assert float(k.abs().max()) <= 2 * (1 / k.shape[0]) ** 0.5 / 0.87962566103423978 + 1e-6


def jax_rays(dataset, camera_index):
    out = jparse(JParserCfg(data=dataset))
    cams = jax.tree_util.tree_map(jnp.asarray, out.cameras)
    return cams.generate_rays(
        camera_index=camera_index, aabb=jnp.asarray(out.scene_box_aabb)
    ).reshape((H * W,))


@pytest.mark.parametrize("camera_index", [0, 3])
def test_eval_render_matches_jax(dataset, jax_model_and_params, camera_index):
    jmodel, params = jax_model_and_params
    rb = jax_rays(dataset, camera_index)
    # chunk 256 over 576 rays: two full chunks and a padded third
    want = jmake_eval_render(jmodel, chunk_size=256)(params, rb)
    bundle = RayBundle(
        **{
            k: torch.from_numpy(np.array(getattr(rb, k)))
            for k in ("origins", "directions", "pixel_area", "camera_indices", "nears", "fars")
        }
    )
    got = make_eval_render(port_model(params), chunk_size=256)(bundle)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["rgb"].shape == (H * W, 3) and got["accumulation"].shape == (H * W, 1)
    for k in ("rgb", "accumulation", "expected_depth", "depth"):
        assert np.all(np.isfinite(got[k].numpy())), k
    # The port's density is the CUDA kernel's contract (f32 tap weights and
    # products); JAX on the CPU runs the XLA one (bf16). Densities then
    # differ by bf16 noise, which the proposal resampling turns into slightly
    # moved samples: 0.02 on rgb and accumulation in [0, 1], and 2% of the
    # depth range on the expected depth.
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], atol=0.02)
    np.testing.assert_allclose(got["accumulation"].numpy(), want["accumulation"], atol=0.02)
    depth_range = float(want["expected_depth"].max() - want["expected_depth"].min())
    np.testing.assert_allclose(
        got["expected_depth"].numpy(), want["expected_depth"], atol=0.02 * max(depth_range, 1e-3)
    )
    # Median depth is an argmax over cum >= 0.5: a ray near 0.5 may step by
    # one sample between frameworks, so compare the share of rays that agree.
    agree = np.isclose(got["depth"].numpy(), want["depth"], rtol=1e-3, atol=1e-4).mean()
    assert agree >= 0.95, agree


def test_render_cli_dataset_cameras(dataset, tmp_path):
    out = tmp_path / "renders"
    rc = render_main(["--data", str(dataset), "--output", str(out), "--device", "cpu", *SMALL_FLAGS])
    assert rc == 0
    from PIL import Image

    rgbs = sorted(out.glob("rgb_*.png"))
    depths = sorted(out.glob("depth_*.png"))
    assert len(rgbs) == N_CAMS and len(depths) == N_CAMS
    assert np.asarray(Image.open(rgbs[0])).shape == (H, W, 3)
    assert np.asarray(Image.open(depths[0])).shape == (H, W)


def test_render_cli_arc(dataset, tmp_path):
    out = tmp_path / "arc"
    rc = render_main(
        ["--data", str(dataset), "--output", str(out), "--arc", "3", "--arc-radius", "2.0",
         "--depth", "false", "--device", "cpu", *SMALL_FLAGS]
    )
    assert rc == 0
    assert len(list(out.glob("rgb_*.png"))) == 3
    assert not list(out.glob("depth_*.png"))


def test_render_cli_load_dir_reproduces_in_memory(dataset, jax_model_and_params, tmp_path):
    """A trainer checkpoint (`step-*.pt`, {"step", "params", "optimizer"})
    rendered by the CLI equals an in-memory render of the same params with
    the appearance codes of the CLI model's own seeded init (restore
    surgery)."""
    from PIL import Image

    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import save_checkpoint
    from signerf_tpu_torch.render import INIT_SEED, build_model
    from signerf_tpu_torch.utils.images import to_uint8

    _, params = jax_model_and_params
    saved = state_dict_from_jax(params)
    saved["field.appearance.embedding"] = saved["field.appearance.embedding"] + 0.5
    ckpt = save_checkpoint(tmp_path / "ckpt", 100, saved)
    assert ckpt.name == "step-000000100.pt"
    out = tmp_path / "loaded"
    rc = render_main(
        ["--data", str(dataset), "--output", str(out), "--load-dir", str(ckpt.parent),
         "--device", "cpu", "--depth", "false", *SMALL_FLAGS]
    )
    assert rc == 0
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=dataset))
    fresh = build_model(NerfactoModelConfig(**SMALL), N_CAMS, torch.device("cpu"), seed=INIT_SEED)
    want = dict(saved)
    want["field.appearance.embedding"] = fresh.state_dict()["field.appearance.embedding"]
    model = NerfactoModel(NerfactoModelConfig(**SMALL), num_train_images=N_CAMS)
    model.load_state_dict(want, strict=True)
    frames = list(render_cameras(model.eval(), parsed.cameras, torch.as_tensor(parsed.scene_box_aabb)))
    assert len(frames) == N_CAMS
    for i, frame in enumerate(frames):
        png = np.asarray(Image.open(out / f"rgb_{i:05d}.png"))
        np.testing.assert_array_equal(png, to_uint8(frame["rgb"].numpy()))  # same code, same bytes


def test_restore_surgery_drops_appearance_and_camera_opt(jax_model_and_params, tmp_path):
    """`render.restore` (and `surgical_restore`) keep the model's own init
    for the appearance codes and camera_opt, and take every other tensor
    from the checkpoint, as the JAX CLIs do (engine/checkpoints.py:113-128)."""
    from signerf_tpu_torch.engine.checkpoints import save_checkpoint
    from signerf_tpu_torch.render import restore

    _, params = jax_model_and_params
    cfg = NerfactoModelConfig(**SMALL, use_camera_opt=True)
    saved = state_dict_from_jax(params)
    saved["field.appearance.embedding"] = saved["field.appearance.embedding"] + 0.5
    saved["camera_opt"] = torch.full((N_CAMS, 6), 0.25)
    ckpt = save_checkpoint(tmp_path, 7, saved)
    model = NerfactoModel(cfg, N_CAMS).reset_parameters(torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    restore(model, ckpt)
    got = model.state_dict()
    assert sorted(got) == sorted(saved)
    for k, v in got.items():
        if k in ("field.appearance.embedding", "camera_opt"):
            assert torch.equal(v, init[k]), k
            assert not torch.equal(v, saved[k]), k
        else:
            assert torch.equal(v, saved[k]), k


def test_render_cli_refuses_cuda_without_a_card(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_main(["--data", str(dataset), "--output", str(tmp_path / "x"), *SMALL_FLAGS])


def test_render_cli_missing_checkpoint(dataset, tmp_path):
    rc = render_main(
        ["--data", str(dataset), "--output", str(tmp_path / "x"), "--load-dir", str(tmp_path),
         "--device", "cpu", *SMALL_FLAGS]
    )
    assert rc == 1


def test_port_imports_no_jax():
    """A fresh interpreter that imports the render, train, eval and export
    CLIs, the diffusion port, the factor-grid kernels' entry points, the hash
    grid, the checkpoint reader (JAX `.ckpt` included), the editing
    geometry, the camera arc, the image cache, the fields, the FLOP model,
    the card's timers, the two example scripts, the probe, the three
    profilers, the data mesh and its test workers and chip_smoke.py has
    neither JAX, flax, msgpack, nor any module of the JAX package loaded
    (tests/test_torch_parallel.py checks the spawned ranks themselves)."""
    code = (
        "import sys; sys.path[:0] = ['examples', 'scripts']; "
        "import fit_synthetic_torch, north_star_pass_torch, probe_edit_mask_torch, profile_render_torch, "
        "profile_train_torch, profile_diffusion_torch, chip_smoke, signerf_tpu_torch.utils.microbench; "
        "import signerf_tpu_torch.render, signerf_tpu_torch.convert, "
        "signerf_tpu_torch.train, signerf_tpu_torch.eval, signerf_tpu_torch.export, "
        "signerf_tpu_torch.ops.hashgrid, signerf_tpu_torch.engine.checkpoints, "
        "signerf_tpu_torch.diffusion.diffuser, signerf_tpu_torch.diffusion.sdxl_pipeline, "
        "signerf_tpu_torch.diffusion.weight_conversion, signerf_tpu_torch.ops.fused_factor_cuda, "
        "signerf_tpu_torch.ops.factor_grid_kernel, signerf_tpu_torch.geometry, "
        "signerf_tpu_torch.geometry.primitives, signerf_tpu_torch.editing.conditions, "
        "signerf_tpu_torch.editing.sheet, signerf_tpu_torch.data.camera_arc, "
        "signerf_tpu_torch.data.datamanager, signerf_tpu_torch.ops.flops, signerf_tpu_torch.models.fields, "
        "signerf_tpu_torch.parallel, signerf_tpu_torch.parallel.mesh, tests.torch_parallel_helpers; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'signerf_tpu', 'msgpack')); print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
