"""The port's export CLI and the pipeline's render hook on the CPU against
the JAX package, on converted params: `pointcloud_from_renders` and
`mesh_from_density`, the marching-tetrahedra copy (exactly JAX's), the PLY
writer and header, `render_camera_fn` in both appearance modes, and the
`pointcloud` and `mesh` subcommands with `--device cpu` (and `--device
cuda` without a card).

Tolerances are the render tests': rgb within 0.02, depth within 2% of its
scale at 97% of the pixels or more; densities within 2% of their scale
(the kernels' twins use f32 taps over bf16 tables, JAX's XLA path bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu import export as jexport
from signerf_tpu.diffusion.diffuser import Diffuser as JDiffuser
from signerf_tpu.diffusion.diffuser import DiffuserConfig as JDiffuserConfig
from signerf_tpu.data import dataparser as jdp
from signerf_tpu.engine.train_step import make_eval_render as jmake_eval_render
from signerf_tpu.geometry import marching as jmarching
from signerf_tpu.models.signerf import SIGNeRFModel as JModel
from signerf_tpu.models.signerf import SIGNeRFModelConfig as JModelConfig
from signerf_tpu_torch import export
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.data import dataparser as tdp
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.geometry import marching
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig
from tests.test_pipeline_e2e import write_tiny_dataset
from tests.test_torch_edit_flow import poses
from tests.test_torch_train import _model_flags

torch.set_num_threads(2)

SMALL = dict(max_res=32, hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
             num_nerf_samples_per_ray=4, use_lpips=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny dataset, and one JAX model's params with the port's model
    holding them."""
    data = write_tiny_dataset(tmp_path_factory.mktemp("export") / "data")
    n = len(tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=data)).image_filenames)
    jmodel = JModel(JModelConfig(**SMALL), num_train_images=n)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(7)))
    model = SIGNeRFModel(SIGNeRFModelConfig(**SMALL), num_train_images=n)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return data, jmodel, params, model.eval()


def test_pointcloud_from_renders_matches_jax(models):
    data, jmodel, params, model = models
    jparsed = jdp.parse_transforms(jdp.SIGNeRFDataParserConfig(data=data))
    tparsed = tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=data))
    jcams = jax.tree_util.tree_map(jnp.asarray, jparsed.cameras).rescaled(0.5)
    tcams = tparsed.cameras.rescaled(0.5)
    jrender, trender = jmake_eval_render(jmodel, chunk_size=8192), make_eval_render(model, chunk_size=8192)
    aabb = np.asarray(tparsed.scene_box_aabb, np.float32)
    kw = dict(min_accumulation=-1.0, num_points=500, log=lambda *_: None)
    jp, jc = jexport.pointcloud_from_renders(lambda f: jrender(params, f, appearance_mode="index"), jcams,
                                              jnp.asarray(aabb), **kw)
    tp, tc = export.pointcloud_from_renders(lambda f: trender(f, appearance_mode="index"), tcams,
                                            torch.from_numpy(aabb), **kw)
    # every ray kept, then the same seeded subsample of 500 of 6 x 12 x 12
    assert tp.shape == jp.shape == (500, 3) and tc.dtype == np.uint8
    np.testing.assert_allclose(tc.astype(np.float32), jc.astype(np.float32), rtol=0, atol=0.02 * 255 + 1)
    np.testing.assert_allclose(tp, jp, rtol=0.02, atol=0.02)
    kept = export.pointcloud_from_renders(lambda f: trender(f, appearance_mode="index"), tcams,
                                          torch.from_numpy(aabb), min_accumulation=2.0, log=lambda *_: None)[0]
    assert kept.shape == (0, 3)  # accumulation never exceeds 1


def test_mesh_from_density_matches_jax(models):
    _, jmodel, params, model = models
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    jdensity = jax.jit(lambda p: jmodel.field.apply({"params": params["field"]}, p, method="density")[0])
    jfn = lambda p: np.asarray(jdensity(jnp.asarray(p)))  # noqa: E731
    tfn = export.density_fn(model, torch.device("cpu"))
    pts = np.random.default_rng(0).uniform(-1, 1, (4096, 3)).astype(np.float32)
    jd, td = jfn(pts).reshape(-1), tfn(pts)
    assert td.shape == (4096,)
    np.testing.assert_allclose(td, jd, rtol=0, atol=0.02 * float(np.abs(jd).max()))
    # the grid, chunking, percentile and extraction: equal on the same densities
    jv, jf = jexport.mesh_from_density(jfn, lo, hi, resolution=12, iso="p60")
    tv, tf = export.mesh_from_density(jfn, lo, hi, resolution=12, iso="p60")
    assert len(tf) > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    # and on the port's own densities, a mesh of about the same size
    pv, pf = export.mesh_from_density(tfn, lo, hi, resolution=12, iso="p60")
    assert abs(len(pf) - len(jf)) <= 0.1 * len(jf)


def test_marching_copy_equals_jax():
    rng = np.random.default_rng(1)
    for vals, iso in [(rng.standard_normal((9, 7, 8)), 0.3),
                      (-np.linalg.norm(np.stack(np.meshgrid(*[np.linspace(-1.5, 1.5, 17)] * 3, indexing="ij"),
                                                -1), axis=-1), -1.0),
                      (np.zeros((4, 4, 4)), 1.0)]:
        origin, spacing = np.array([-1.0, 0.5, 2.0]), np.array([0.1, 0.2, 0.3])
        tv, tf = marching.marching_tetrahedra(vals, origin, spacing, iso)
        jv, jf = jmarching.marching_tetrahedra(vals, origin, spacing, iso)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_ply_and_obj_writers_equal_jax(tmp_path):
    pts = np.random.RandomState(0).randn(17, 3).astype(np.float32)
    cols = (np.random.RandomState(1).rand(17, 3) * 255).astype(np.uint8)
    export.write_ply(tmp_path / "t.ply", pts, cols)
    jexport.write_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert export.read_ply_header(tmp_path / "t.ply") == jexport.read_ply_header(tmp_path / "t.ply") == 17
    verts, faces = marching.marching_tetrahedra(np.random.default_rng(2).standard_normal((5, 5, 5)), np.zeros(3),
                                                np.ones(3), 0.0)
    marching.save_obj(tmp_path / "t.obj", verts, faces)
    jmarching.save_obj(tmp_path / "j.obj", verts, faces)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


# ---------------------------------------------------------------------------
# The pipeline's render hook on converted params
# ---------------------------------------------------------------------------


def test_render_camera_fn_matches_jax(tmp_path):
    """`render_camera_fn` of both pipelines on the same converted weights:
    the datamanager's own cameras (appearance mode `index`) and novel poses
    (`mean`), at the render tests' bound: rgb and accumulation within 0.02,
    depth within 2% of its largest value at 97% of the pixels or more."""
    from signerf_tpu.data.datamanager import SIGNeRFDataManagerConfig as JDMConfig
    from signerf_tpu.pipeline import SIGNeRFPipeline as JPipeline
    from signerf_tpu.pipeline import SIGNeRFPipelineConfig as JPipelineConfig
    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManagerConfig
    from signerf_tpu_torch.pipeline import SIGNeRFPipeline, SIGNeRFPipelineConfig

    data = write_tiny_dataset(tmp_path / "data")
    small = dict(max_res=32, hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
                 num_nerf_samples_per_ray=4, use_lpips=False, eval_num_rays_per_chunk=256)
    jpipe = JPipeline(JPipelineConfig(datamanager=JDMConfig(dataparser=jdp.SIGNeRFDataParserConfig(data=data)),
                                      model=JModelConfig(**small)), diffuser=JDiffuser(JDiffuserConfig(mode="custom")))
    tpipe = SIGNeRFPipeline(SIGNeRFPipelineConfig(datamanager=SIGNeRFDataManagerConfig(
        dataparser=tdp.SIGNeRFDataParserConfig(data=data)), model=SIGNeRFModelConfig(**small)), "cpu",
        diffuser=Diffuser(DiffuserConfig(mode="custom")))
    jpipe.params = jax.tree_util.tree_map(np.asarray, jax.jit(jpipe.model.init)(jax.random.PRNGKey(5)))
    tpipe.model.load_state_dict(state_dict_from_jax(jpipe.params), strict=True)
    assert tpipe.dataset_generator.config.width == jpipe.dataset_generator.config.width == 24
    novel = poses(2, 50.0, 90.0)
    for mode, jcams, tcams in [
        ("index", jpipe.datamanager.cameras, tpipe.datamanager.cameras),
        ("mean", jpipe.dataset_generator._cameras_from_poses(novel), tpipe.dataset_generator._cameras_from_poses(novel)),
    ]:
        for i in range(2):
            jo, to = jpipe.render_camera_fn(jcams, i), tpipe.render_camera_fn(tcams, i)
            assert tuple(to["rgb"].shape) == (24, 24, 3) and tuple(to["depth"].shape) == (24, 24, 1)
            np.testing.assert_allclose(to["rgb"].numpy(), np.asarray(jo["rgb"]), rtol=0, atol=0.02, err_msg=mode)
            np.testing.assert_allclose(to["accumulation"].numpy(), np.asarray(jo["accumulation"]), rtol=0,
                                       atol=0.02, err_msg=mode)
            # the median depth may step by one sample where a ray's weights
            # cross 0.5 between the frameworks
            near = np.abs(to["depth"].numpy() - np.asarray(jo["depth"])) <= 0.02 * float(np.max(jo["depth"]))
            assert near.mean() >= 0.97, (mode, near.mean())


# ---------------------------------------------------------------------------
# The export CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from signerf_tpu_torch import train as train_cli

    tmp = tmp_path_factory.mktemp("export_cli")
    data = write_tiny_dataset(tmp / "data")
    assert train_cli.main(["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
                           "--max-num-iterations", "4", "--steps-per-call", "2", "--output-dir", str(tmp / "out"),
                           "--pipeline.datamanager.train-num-rays-per-batch", "64",
                           *_model_flags("pipeline.model.")]) == 0
    return tmp, data, tmp / "out" / "experiment" / "signerf_nerfacto" / "checkpoints"


def test_export_pointcloud_cli(checkpoint):
    tmp, data, ckpt_dir = checkpoint
    out = tmp / "pc.ply"
    assert export.main(["pointcloud", "--data", str(data), "--load-dir", str(ckpt_dir), "--output", str(out),
                        "--downscale", "2", "--min-accumulation", "0.0", "--num-points", "300", "--device", "cpu",
                        *_model_flags("model.")]) == 0
    assert 0 < export.read_ply_header(out) <= 300
    body = out.read_bytes().split(b"end_header\n", 1)[1]
    assert len(body) == export.read_ply_header(out) * 15


def test_export_mesh_cli_loads_as_a_proxy(checkpoint):
    from signerf_tpu_torch.geometry.obj import load_obj

    tmp, data, ckpt_dir = checkpoint
    out = tmp / "mesh.obj"
    assert export.main(["mesh", "--data", str(data), "--load-dir", str(ckpt_dir), "--output", str(out),
                        "--resolution", "16", "--iso", "p50", "--device", "cpu", *_model_flags("model.")]) == 0
    verts, faces = load_obj(out)
    assert len(verts) > 0 and len(faces) > 0


def test_export_cli_refusals(checkpoint, monkeypatch):
    _, data, _ = checkpoint
    assert export.main(["voxels"]) == 1
    with pytest.raises(ValueError, match="unknown flags"):
        export.main(["mesh", "--data", str(data), "--device", "cpu", "--nope", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for sub in ("pointcloud", "mesh"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.main([sub, "--data", str(data)])
