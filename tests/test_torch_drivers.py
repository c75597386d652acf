"""The port's example scripts against the JAX package on the CPU: `Cameras`'
image sizes, examples/fit_synthetic_torch.py's scene,
examples/north_star_pass_torch.py's dataset, its world-to-scene mapping of
the edit box and the reference poses, the pass end to end at a tiny size
with the result schema of the JAX script's committed run, and the refusals
without a card (the examples, the profilers and `utils/microbench`).

The JAX scripts run their work at import (north_star_pass.py) or turn on a
compile cache (both), so their computations are rebuilt here from the JAX
package's own functions, line for line.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from signerf_tpu.cameras.cameras import Cameras as JCameras
from signerf_tpu.cameras.poses import circle_poses as jcircle_poses
from signerf_tpu.data import dataparser as jdp
from signerf_tpu.utils.images import save_array_png as jsave_array_png
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.data import dataparser as tdp
from signerf_tpu_torch.diffusion.diffuser import Diffuser
from signerf_tpu_torch.models.nerfacto import ProposalNetArgs
from signerf_tpu_torch.utils import microbench
from signerf_tpu_torch.utils.images import load_rgb
from tests.test_torch_edit_flow import fake_diffuse

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "examples"), str(ROOT / "scripts")]

import fit_synthetic_torch  # noqa: E402
import north_star_pass_torch as ns  # noqa: E402
import probe_edit_mask_torch  # noqa: E402
import profile_diffusion_torch  # noqa: E402
import profile_render_torch  # noqa: E402
import profile_train_torch  # noqa: E402

torch.set_num_threads(2)

POSE_TOL = 1e-6
MAPPING_TOL = 1e-5
ONE_LEVEL = 1  # 8-bit PNG values


def jax_sphere_on_white(o, d):
    """examples/fit_synthetic.py's `analytic_rgb`."""
    b = jnp.sum(o * d, -1)
    c = jnp.sum(o * o, -1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    p = o + d * t[..., None]
    return jnp.where(hit[..., None], jnp.abs(p), jnp.ones_like(p))


def jax_sphere_on_backdrop(o, d):
    """examples/north_star_pass.py's `analytic_rgb`."""
    b = jnp.sum(o * d, -1)
    c = jnp.sum(o * o, -1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    p = o + d * t[..., None]
    bg = 0.55 + 0.3 * d
    return jnp.where(hit[..., None], jnp.abs(p), jnp.clip(bg, 0, 1))


@pytest.mark.parametrize("width,height", [(128, 128), (1024, 768), (31, 17)])
def test_camera_image_sizes_match_jax(width, height):
    c2w = np.tile(np.eye(4, dtype=np.float32)[None, :3], (2, 1, 1))
    one = np.ones(2, np.float32)
    jcam = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(one), fy=jnp.asarray(one),
                    cx=jnp.asarray(one), cy=jnp.asarray(one), width=width, height=height)
    tcam = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(one), fy=torch.from_numpy(one),
                   cx=torch.from_numpy(one), cy=torch.from_numpy(one), width=width, height=height)
    assert (tcam.image_width, tcam.image_height) == (jcam.image_width, jcam.image_height) == (width, height)
    sub = tcam.slice(torch.tensor([1]))
    assert (sub.image_width, sub.image_height) == (width, height)


def test_fit_synthetic_scene_matches_jax():
    """The 16 cameras of 128 px and their uint8 images, as
    examples/fit_synthetic.py builds them."""
    cams, images = fit_synthetic_torch.scene(torch.device("cpu"))
    n, size = fit_synthetic_torch.VIEWS, fit_synthetic_torch.SIZE
    poses = jcircle_poses(16, radius=3.0, theta=60.0, phi=(0.0, 337.5))[:, :3, :]
    jcams = JCameras(camera_to_worlds=jnp.asarray(poses), fx=jnp.full((16,), 160.0), fy=jnp.full((16,), 160.0),
                     cx=jnp.full((16,), size / 2), cy=jnp.full((16,), size / 2), width=size, height=size)
    want = np.stack([
        np.asarray((jax_sphere_on_white(jcams.generate_rays(camera_index=i).origins,
                                        jcams.generate_rays(camera_index=i).directions) * 255).astype(jnp.uint8))
        for i in range(16)])
    assert n == 16 and images.dtype == torch.uint8 and tuple(images.shape) == (16, size, size, 3)
    np.testing.assert_allclose(cams.camera_to_worlds.numpy(), np.asarray(poses), rtol=0, atol=POSE_TOL)
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(cams, name).numpy(), np.asarray(getattr(jcams, name)), rtol=0, atol=0)
    diff = np.abs(images.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= ONE_LEVEL, diff.max()


def jax_build_dataset(data: Path, n_views: int, size: int) -> None:
    """examples/north_star_pass.py's `build_dataset` (:58-115) through the
    JAX package, with its 1024 px and focal 1200 as `size` and
    1200 * size / 1024."""
    (data / "images").mkdir(parents=True, exist_ok=True)
    poses = np.asarray(jcircle_poses(n_views, radius=3.0, theta=60.0, phi=(0.0, 360.0 * (n_views - 1) / n_views)))
    focal = 1200.0 * size / 1024
    frames = []
    for i in range(n_views):
        cams = JCameras(camera_to_worlds=jnp.asarray(poses[i : i + 1, :3]), fx=jnp.array([focal]),
                        fy=jnp.array([focal]), cx=jnp.array([size / 2]), cy=jnp.array([size / 2]), width=size,
                        height=size)
        rb = cams.generate_rays(0)
        jsave_array_png(np.asarray(jax_sphere_on_backdrop(rb.origins, rb.directions)),
                        data / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
    (data / "transforms.json").write_text(json.dumps({
        "camera_model": "OPENCV", "fl_x": focal, "fl_y": focal, "cx": size / 2, "cy": size / 2, "w": size, "h": size,
        "frames": frames}))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("north_star")
    ns.build_dataset(root / "port", 4, 32, torch.device("cpu"))
    jax_build_dataset(root / "jax", 4, 32)
    return root / "port", root / "jax"


def test_north_star_dataset_matches_jax(datasets):
    port, jax_dir = datasets
    got, want = (json.loads((d / "transforms.json").read_text()) for d in datasets)
    assert {k: v for k, v in got.items() if k != "frames"} == {k: v for k, v in want.items() if k != "frames"}
    assert [f["file_path"] for f in got["frames"]] == [f["file_path"] for f in want["frames"]]
    np.testing.assert_allclose(np.array([f["transform_matrix"] for f in got["frames"]]),
                               np.array([f["transform_matrix"] for f in want["frames"]]), rtol=0, atol=POSE_TOL)
    for f in got["frames"]:
        a, b = (load_rgb(d / f["file_path"]).astype(np.int32) for d in datasets)
        assert a.shape == b.shape == (32, 32, 3) and np.abs(a - b).max() <= ONE_LEVEL, f["file_path"]


def jax_world_to_scene(dpo):
    """examples/north_star_pass.py:184-210 on the JAX dataparser's outputs:
    the scene-space edit box and the 8 reference poses."""
    t_ds = np.asarray(dpo.dataparser_transform, np.float32)
    s_ds = float(dpo.dataparser_scale)
    lo, hi = np.array([-0.65, -0.65, 0.6], np.float32), np.array([0.65, 0.65, 1.05], np.float32)
    corners = np.array([[[lo, hi][i][0], [lo, hi][j][1], [lo, hi][k][2]]
                        for i in range(2) for j in range(2) for k in range(2)], np.float32)
    corners_scene = s_ds * (corners @ t_ds[:, :3].T + t_ds[:, 3])
    c2w = np.asarray(jcircle_poses(8, radius=3.0, theta=55.0, phi=(0.0, 315.0)))[:, :3]
    rot = np.einsum("ij,njk->nik", t_ds[:, :3], c2w[:, :3, :3])
    t = s_ds * (c2w[:, :3, 3] @ t_ds[:, :3].T + t_ds[:, 3])
    return corners_scene.min(axis=0), corners_scene.max(axis=0), np.concatenate([rot, t[..., None]], axis=-1)


def test_north_star_world_to_scene_matches_jax(datasets):
    port, _ = datasets
    jout = jdp.parse_transforms(jdp.SIGNeRFDataParserConfig(data=port, downscale_factor=1))
    tout = tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=port, downscale_factor=1))
    want_lo, want_hi, want_ref = jax_world_to_scene(jout)
    lo, hi = ns.scene_aabb(tout.dataparser_transform, tout.dataparser_scale)
    ref = ns.reference_poses(tout.dataparser_transform, tout.dataparser_scale)
    np.testing.assert_allclose(np.array(lo), want_lo, rtol=0, atol=MAPPING_TOL)
    np.testing.assert_allclose(np.array(hi), want_hi, rtol=0, atol=MAPPING_TOL)
    assert ref.shape == (8, 3, 4)
    np.testing.assert_allclose(ref, want_ref, rtol=0, atol=MAPPING_TOL)
    # the world edit box clips the sphere's top cap, so it is not degenerate
    assert all(b - a > 0.1 for a, b in zip(lo, hi))


def narrow(cfg):
    """A model and batch small enough for the CPU; 16 x 16 patches."""
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, max_res=32, hidden_dim=8, hidden_dim_color=8, appearance_embed_dim=4,
        num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4, patch_size=16, eval_num_rays_per_chunk=512,
        proposal_net_args_list=(ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8),
                                ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8)))
    cfg.pipeline.datamanager.train_num_rays_per_batch = 512
    cfg.pipeline.datamanager.patch_size = 16
    cfg.steps_per_call = 1
    cfg.pipeline.dataset_generator.mask_dilation = (3, 3)


def finite_numbers(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def test_north_star_main_end_to_end_on_the_cpu(tmp_path):
    """The whole pass at 2 views of 32 px, a narrowed model, 2 pretrain and
    2 refinement steps, and the `custom` fake diffuser: the result carries
    the JAX run's keys (examples/north_star_result.json) but its TPU
    projection, plus `reduced` and the generator's batch size."""
    out = tmp_path / "ns"
    result = ns.main(["2", "2", "2", "--device", "cpu", "--size", "32", "--out", str(out), "--result",
                      str(tmp_path / "result.json")], configure=narrow,
                     make_diffuser=lambda c: Diffuser(dataclasses.replace(c, mode="custom"), custom_fn=fake_diffuse,
                                                      device="cpu"),
                     reduced=["model narrowed to the CPU's size"])
    jax_keys = set(json.loads((ROOT / "examples" / "north_star_result.json").read_text()))
    assert set(result) == {k for k in jax_keys if not k.startswith("v5e8_")} | {"reduced", "generation_batch_size"}
    assert finite_numbers(result)
    assert json.loads((tmp_path / "result.json").read_text()) == json.loads(
        (out / "north_star_result_torch.json").read_text()) == result
    assert result["n_views"] == 2 and result["refine_steps"] == 2 and result["pretrain_steps"] == 2
    assert result["generation_batch_size"] == 4 and result["hardware"] == "CPU"
    assert result["reduced"] == ["n_views 2 (reference 100)", "refine_steps 2 (reference 20000)",
                                 "size 32 (reference 1024)", "pretrain_steps 2 (reference 8000)",
                                 "model narrowed to the CPU's size"]
    meta = json.loads((out / "generations" / "edit0" / "transforms.json").read_text())
    assert len(meta["frames"]) == 8 + 2 and meta["reference_indices"] == list(range(8))
    assert (out / "refined_render_0.png").exists()


def test_probe_then_the_pass_from_its_checkpoint(tmp_path):
    """scripts/probe_edit_mask_torch.py pretrains with the pass's config and
    reads the 8 reference masks after each step count; the pass then edits
    from the saved checkpoint (`load_dir`) without a pretrain of its own,
    on another ring of the same scene, and names the loaded steps as a cut."""
    from signerf_tpu_torch.engine.checkpoints import save_checkpoint

    trainer, rows = probe_edit_mask_torch.probe(tmp_path / "probe", 3, 32, [1, 2], torch.device("cpu"),
                                                configure=narrow)
    assert [r["steps"] for r in rows] == [1, 2] and trainer.step == 2
    for r in rows:
        assert all(len(r[k]) == ns.REFERENCE_VIEWS and all(0.0 <= v <= 1.0 for v in r[k])
                   for k in ("coverage", "in_front", "behind"))
    ckpt = save_checkpoint(tmp_path / "ckpt", trainer.step, trainer.pipeline.model.state_dict(), trainer.optimizer)
    filled = dict(rows[0], coverage=[0.5] * ns.REFERENCE_VIEWS)
    with pytest.MonkeyPatch.context() as mp:  # stop at the first count where every mask is non-empty
        mp.setattr(probe_edit_mask_torch, "reference_masks", lambda t: {k: filled[k] for k in
                                                                        ("coverage", "in_front", "behind")})
        t2, rows2 = probe_edit_mask_torch.probe(tmp_path / "probe2", 3, 32, [1, 2], torch.device("cpu"),
                                                configure=narrow, until_filled=True)
    assert [r["steps"] for r in rows2] == [1] and t2.step == 1
    result = ns.main(["2", "2", "7", str(ckpt.parent), "--device", "cpu", "--size", "32", "--out",
                      str(tmp_path / "ns")], configure=narrow,
                     make_diffuser=lambda c: Diffuser(dataclasses.replace(c, mode="custom"), custom_fn=fake_diffuse,
                                                      device="cpu"))
    assert result["pretrain_steps"] == 0 and result["phases_s"]["pretrain"] == 0.0
    assert result["loaded_checkpoint"] == str(ckpt.parent)
    assert "pretrain_steps 2 (the loaded checkpoint) (reference 8000)" in result["reduced"]
    with pytest.raises(FileNotFoundError):
        ns.main(["2", "2", "7", str(tmp_path), "--device", "cpu", "--size", "32", "--out", str(tmp_path / "x")])


def test_edit_landing_reads_the_mask_with_the_ports_decoder(tmp_path):
    from signerf_tpu_torch.utils.images import save_array_png

    mask = np.zeros((8, 8, 1), np.float32)
    mask[2:6, 2:6] = 1.0
    save_array_png(mask, tmp_path / "mask_0.png")
    pre = np.zeros((8, 8, 3), np.float32)
    post = pre.copy()
    post[2:6, 2:6] = 0.5
    post[0, 0] = 0.1
    got = ns.edit_landing(pre, post, tmp_path / "mask_0.png")
    assert got["coverage"] == pytest.approx(16 / 64)
    assert got["masked"] == pytest.approx(0.5) and got["unmasked"] == pytest.approx(0.1 / 48)
    assert got["ratio"] == pytest.approx(0.5 / (0.1 / 48))


def test_no_card_no_fallback(monkeypatch, tmp_path):
    """Without a card the timers, the examples and the profilers raise; none
    of them times or trains on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: microbench.cuda_ms(lambda: None, 1), lambda: microbench.cuda_time_stats(lambda: None),
                 lambda: microbench.kernel_breakdown(lambda: None, []), microbench.card_name,
                 lambda: microbench.Stages().time("x", lambda: None)):
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_synthetic_torch.main(1, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ns.main(["2", "2", "2", "--size", "32", "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_edit_mask_torch.main(["--steps", "1", "--rays", "64", "--out", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()
    for profiler in (profile_render_torch, profile_train_torch, profile_diffusion_torch):
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            profiler.main()
