"""The port's last small modules and knobs against the JAX package:
`data/camera_arc.py` (poses, intrinsics, every camera's rays, the loaders'
order), `CachedImageStore` and the datamanager's knobs (a JAX-written
`config.yml` loads), `CameraType` and `Cameras.camera_type`, the
optimizer's `fused_update`, and the FLOP model `ops/flops.py` (the
hardware-neutral counts equal JAX's; the port's nerfacto counts by hand).

Inputs are numpy arrays or files from a seed, handed to both packages.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from signerf_tpu import config as jcfglib
from signerf_tpu.cameras import cameras as jcams
from signerf_tpu.data import camera_arc as jarc
from signerf_tpu.data import datamanager as jdm
from signerf_tpu.diffusion import unet as junet
from signerf_tpu.method_configs import METHODS as JMETHODS
from signerf_tpu.ops import flops as jflops
from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.cameras import cameras as tcams
from signerf_tpu_torch.data import camera_arc as tarc
from signerf_tpu_torch.data import datamanager as tdm
from signerf_tpu_torch.diffusion import unet as tunet
from signerf_tpu_torch.engine import optimizers as topt
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainerConfig
from signerf_tpu_torch.method_configs import METHODS
from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig, ProposalNetArgs
from signerf_tpu_torch.ops import flops as tflops
from tests.test_pipeline_e2e import write_tiny_dataset

torch.set_num_threads(2)

ARC = dict(num_cameras=5, radius=2.5, theta=60.0, phi_range=(10.0, 300.0), target=(0.1, -0.2, 0.3),
           position=(0.5, 0.0, -0.25), width=24, height=16, fx=20.0, fy=22.0)


# ---------------------------------------------------------------------------
# the camera arc
# ---------------------------------------------------------------------------


def test_camera_arc_poses_intrinsics_and_rays_match_jax():
    j = jarc.CameraArcDataset(jarc.CameraArcDatasetConfig(**ARC))
    t = tarc.CameraArcDataset(tarc.CameraArcDatasetConfig(**ARC), device="cpu")
    assert len(t) == len(j) == 5 and t.cameras.device.type == "cpu"
    assert (t.cameras.width, t.cameras.height) == (24, 16)
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(t.cameras, name).numpy(), np.asarray(getattr(j.cameras, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    for i in range(5):
        for box in (None, aabb):
            jb = j.cameras.generate_rays(camera_index=i, aabb=None if box is None else jnp.asarray(box))
            tb = t.cameras.generate_rays(camera_index=i, aabb=None if box is None else torch.from_numpy(box))
            for name in ("origins", "directions", "pixel_area", "nears", "fars"):
                a, b = getattr(tb, name), getattr(jb, name)
                if b is None:
                    assert a is None, name
                    continue
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
            np.testing.assert_array_equal(tb.camera_indices.numpy(), np.asarray(jb.camera_indices))
    # the defaults are JAX's
    for f in dataclasses.fields(jarc.CameraArcDatasetConfig):
        assert getattr(tarc.CameraArcDatasetConfig(), f.name) == getattr(jarc.CameraArcDatasetConfig(), f.name)


def test_eval_loaders_walk_the_cameras_in_jax_order():
    j = jarc.CameraArcDataset(jarc.CameraArcDatasetConfig(**ARC))
    t = tarc.CameraArcDataset(tarc.CameraArcDatasetConfig(**ARC), device="cpu")
    jl, tl = jarc.EvalCameraDataloader(j.cameras), tarc.EvalCameraDataloader(t.cameras)
    order = [next(tl) for _ in range(12)]
    assert [i for i, _ in order] == [next(jl)[0] for _ in range(12)] == [k % 5 for k in range(12)]
    i, bundle = order[7]
    assert tuple(bundle.shape) == (16, 24) and int(bundle.camera_indices[0, 0, 0]) == i == 2
    indices = [3, 0, 3, 1]
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    jf = jarc.FixedIndicesEvalCameraDataloader(j.cameras, indices, aabb)
    tf = tarc.FixedIndicesEvalCameraDataloader(t.cameras, indices, torch.from_numpy(aabb))
    got, want = list(tf), list(jf)
    assert [i for i, _ in got] == [i for i, _ in want] == indices
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.fars.numpy(), np.asarray(b.fars), rtol=0, atol=1e-6)
    assert [i for i, _ in tf] == indices
    with pytest.raises(TypeError):
        next(tf)


def test_camera_type_is_carried():
    assert [(m.name, int(m)) for m in tcams.CameraType] == [(m.name, int(m)) for m in jcams.CameraType]
    c2w = torch.eye(4)[:3].expand(3, 3, 4).clone()
    c2w[:, 0, 3] = torch.arange(3.0)
    ones = torch.ones(3)
    cams = tcams.Cameras(camera_to_worlds=c2w, fx=ones * 10, fy=ones * 11, cx=ones * 4, cy=ones * 3,
                         width=8, height=6, camera_type=int(tcams.CameraType.FISHEYE))
    assert tcams.Cameras(camera_to_worlds=c2w, fx=ones, fy=ones, cx=ones, cy=ones).camera_type == 0
    for other in (cams.slice(slice(1, 3)), cams[torch.tensor([2, 0])], cams.to("cpu"), cams.rescaled(0.5)):
        assert other.camera_type == int(tcams.CameraType.FISHEYE)
    sub = cams[torch.tensor([2, 0])]
    assert len(sub) == 2 and float(sub.camera_to_worlds[0, 0, 3]) == 2.0 and (sub.width, sub.height) == (8, 6)
    assert len(cams.slice(1).fx.shape) == 0 and cams.slice(1).distortion_params is None


# ---------------------------------------------------------------------------
# the image cache and the datamanager's knobs
# ---------------------------------------------------------------------------


def test_cached_image_store_matches_jax(tmp_path):
    """4 of the images, resampled every 2 fetches: over 5 fetches the same
    subsets (numpy's RandomState draws) and the same uint8 rows, resized
    to the store's 8 x 8 as the JAX loader resizes them."""
    from tests.test_pipeline_e2e import N_CAMS

    data = write_tiny_dataset(tmp_path / "data")
    files = sorted((data / "images").glob("*.png"))
    assert len(files) == N_CAMS >= 4
    files = files * 2  # 2 x N_CAMS "images", some the same file
    h = w = 8
    j = jdm.CachedImageStore(files, w, h, cache_size=4, resample_every=2, seed=3)
    t = tdm.CachedImageStore(files, w, h, cache_size=4, resample_every=2, seed=3, device="cpu")
    full = tdm.load_images(files, w, h)
    seen = set()
    for _ in range(5):
        (ti, tidx), (ji, jidx) = t.fetch(), j.fetch()
        np.testing.assert_array_equal(tidx, jidx)
        assert ti.dtype == torch.uint8 and ti.device.type == "cpu" and tuple(ti.shape) == (4, h, w, 3)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(ti.numpy(), full[tidx])
        seen.add(tuple(tidx))
    assert len(seen) == 3  # fetches 2 and 4 resampled
    never = tdm.CachedImageStore(files, w, h, cache_size=20, device="cpu")
    assert never.cache_size == len(files) and all(np.array_equal(never.fetch()[1], never.current_indices)
                                                  for _ in range(3))


def test_datamanager_knobs_and_a_jax_config_yml_load(tmp_path):
    """`eval_num_rays_per_batch`, `cache_images` and `cache_resample_every`
    with JAX's defaults and method values; a JAX-written `config.yml` that
    sets them loads into the port's trainer config."""
    for f in ("eval_num_rays_per_batch", "cache_images", "cache_resample_every"):
        assert getattr(tdm.SIGNeRFDataManagerConfig(), f) == getattr(jdm.SIGNeRFDataManagerConfig(), f), f
    for name in ("signerf", "signerf_nerfacto"):
        t, j = METHODS[name]().pipeline.datamanager, JMETHODS[name]().pipeline.datamanager
        assert (t.eval_num_rays_per_batch, t.cache_images, t.cache_resample_every) == (
            j.eval_num_rays_per_batch, j.cache_images, j.cache_resample_every)
    j = JMETHODS["signerf_nerfacto"]()
    j.pipeline.datamanager.eval_num_rays_per_batch = 1024
    j.pipeline.datamanager.cache_images = 4
    j.pipeline.datamanager.cache_resample_every = 2
    jcfglib.save_yaml(j, tmp_path / "config.yml")
    t = cfglib.load_yaml(SIGNeRFTrainerConfig, tmp_path / "config.yml")
    dm = t.pipeline.datamanager
    assert (dm.eval_num_rays_per_batch, dm.cache_images, dm.cache_resample_every) == (1024, 4, 2)
    over = cfglib.apply_overrides(METHODS["signerf_nerfacto"](), cfglib.parse_cli_overrides(
        ["--pipeline.datamanager.cache-images", "3", "--pipeline.datamanager.cache-resample-every", "5"]))
    assert (over.pipeline.datamanager.cache_images, over.pipeline.datamanager.cache_resample_every) == (3, 5)


# ---------------------------------------------------------------------------
# the optimizer's two update paths
# ---------------------------------------------------------------------------


def test_fused_and_per_tensor_updates_are_equal():
    """`fused_update` True (one multi-tensor pass a group) and False (tensor
    by tensor) give the same parameters and moments, bit for bit, over four
    steps of every group (AdamW's decay on the appearance codes included);
    tests/test_torch_train.py holds each against JAX's own two paths."""
    rng = np.random.default_rng(0)
    shapes = {"field.lines.l0": (9, 4), "field.mlp.w": (16, 8), "field.appearance.embedding": (3, 5),
              "proposal_0.w": (7, 4), "camera_opt": (3, 6)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    runs = {}
    for fused in (True, False):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        opt = topt.GroupedAdam(topt.OptimizersConfig(fused_update=fused), params.items())
        grng = np.random.default_rng(1)
        for _ in range(4):
            for k, p in params.items():
                p.grad = torch.from_numpy(grng.standard_normal(p.shape).astype(np.float32))
            opt.step()
        runs[fused] = (params, opt.state)
    for k in init:
        torch.testing.assert_close(runs[True][0][k], runs[False][0][k], rtol=0, atol=0)
    for g, st in runs[True][1].items():
        for a, b in zip(st["m"] + st["v"], runs[False][1][g]["m"] + runs[False][1][g]["v"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert topt.OptimizersConfig().fused_update is True


# ---------------------------------------------------------------------------
# the FLOP model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "sdxl"])
def test_hardware_neutral_counts_equal_jax(name):
    tcfg = tunet.TINY_UNET_CONFIG if name == "tiny" else tunet.SDXL_UNET_CONFIG
    jcfg = junet.TINY_UNET_CONFIG if name == "tiny" else junet.SDXL_UNET_CONFIG
    for hw in ((8, 8), (64, 48), (192, 192)):
        assert tflops.unet_flops(tcfg, hw) == jflops.unet_flops(jcfg, hw)
        assert tflops.unet_flops(tcfg, hw, 7, encoder_only=True) == jflops.unet_flops(jcfg, hw, 7, encoder_only=True)
        assert tflops.controlnet_flops(tcfg, hw) == jflops.controlnet_flops(jcfg, hw)
        for batch, control in ((2, True), (1, False)):
            assert tflops.sdxl_denoise_step_flops(tcfg, hw, 77, batch, control) == jflops.sdxl_denoise_step_flops(
                jcfg, hw, 77, batch, control)
    assert tflops._conv2d_flops((9, 7), 3, 5, k=3, stride=2) == jflops._conv2d_flops((9, 7), 3, 5, k=3, stride=2)
    assert tflops._resnet_flops((4, 4), 8, 16, 32) == jflops._resnet_flops((4, 4), 8, 16, 32)
    assert tflops._transformer_flops((4, 6), 32, 2, 77, 64) == jflops._transformer_flops((4, 6), 32, 2, 77, 64)
    for dims in ([128, 64, 16], [63, 64, 64, 3], [40, 1]):
        assert tflops.mlp_flops(dims) == jflops.mlp_flops(dims)


def test_nerfacto_counts_by_hand_and_the_peaks():
    """`signerf_nerfacto`'s defaults: base field 8 levels x 16 features, 11
    f32 operations a feature (three axes' two-tap lerps of 3, the product's
    2); base MLP 128 -> 64 -> 16 on the tensor cores (K1); the color head
    (16 + 15 + 32) -> 64 -> 64 -> 3 in f32; proposal fields 5 x 8 features,
    40 -> 16 -> 1 in K1, or 40 -> 1 in f32 when linear."""
    f = tflops.nerfacto_flops(NerfactoModelConfig())
    assert f.field_encode == 8 * 16 * 11 == 1408
    assert f.field_mlp_tc == 2 * (128 * 64 + 64 * 16) == 18432
    assert f.field_mlp_f32 == 2 * (63 * 64 + 64 * 64 + 64 * 3) == 16640
    assert f.proposal_encode == (440, 440) and f.proposal_mlp_tc == (1312, 1312) and f.proposal_mlp_f32 == (0, 0)
    tc = 48 * 18432 + (256 + 96) * 1312
    f32 = 48 * (1408 + 16640) + (256 + 96) * 440
    assert (f.render_tc_per_ray, f.render_f32_per_ray, f.render_per_ray) == (tc, f32, tc + f32)
    assert (f.train_tc_per_ray, f.train_f32_per_ray, f.train_per_ray) == (3 * tc, 3 * f32, 3 * (tc + f32))
    linear = NerfactoModelConfig(proposal_net_args_list=(ProposalNetArgs(max_res=128, use_linear=True),
                                                         ProposalNetArgs(max_res=256, use_linear=True)))
    g = tflops.nerfacto_flops(linear)
    assert g.proposal_mlp_tc == (0, 0) and g.proposal_mlp_f32 == (80, 80)
    assert g.render_tc_per_ray == 48 * 18432 and g.render_f32_per_ray == f32 + (256 + 96) * 80
    # gradient normals take the base MLP out of the kernels; so does the switch
    n = tflops.nerfacto_flops(NerfactoModelConfig(predict_normals=True))
    assert n.field_mlp_tc == 0 and n.field_mlp_f32 == 18432 + 16640 + 2 * (31 * 64 + 64 * 64 + 64 * 3)
    u = tflops.nerfacto_flops(NerfactoModelConfig(use_fused_density=False))
    assert u.render_tc_per_ray == 0 and u.render_per_ray == f.render_per_ray
    assert "field encode" in tflops.breakdown_str(f)
    assert tflops.utilization(1e6, 2e6, tflops.F32_FLOP_PER_S) == pytest.approx(100 * 2e12 / 67e12)
    # the peaks are chip_smoke.py's, which its bounds use
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for name in ("BF16_FLOP_PER_S", "F32_FLOP_PER_S"):
        assert float(re.search(rf"^{name} = (\S+)$", smoke, re.M).group(1)) == getattr(tflops, name)
