"""The port's edit flow on the CPU against the JAX package: the dataset
generator end to end with the same analytic render and the same `custom`
fake diffuser (both generation batch sizes, synthetic and original-dataset
modes, the merge with inverted masks, shape mode with the bunny proxy, the
empty-mask warning), the dataparser's pose inverse and previous-experiment
cameras, the loader's resize, `config.yml` across the packages, and the
imports.

Inputs are made with numpy from a seed and handed to both frameworks; the
render function returns the same numpy arrays to both generators, so
everything downstream of it is compared.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu import config as jcfg
from signerf_tpu.cameras.cameras import Cameras as JCameras
from signerf_tpu.cameras.poses import circle_poses as jcircle_poses
from signerf_tpu.data import datamanager as jdm
from signerf_tpu.data import dataparser as jdp
from signerf_tpu.diffusion.diffuser import Diffuser as JDiffuser
from signerf_tpu.diffusion.diffuser import DiffuserConfig as JDiffuserConfig
from signerf_tpu.generator import datasetgenerator as jgen
from signerf_tpu_torch import config as tcfg
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.data import datamanager as tdm
from signerf_tpu_torch.data import dataparser as tdp
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.generator import datasetgenerator as tgen
from signerf_tpu_torch.utils.images import load_rgb, save_array_png

torch.set_num_threads(2)

H = W = 32
FOCAL = 40.0
GREEN = np.array([0.1, 0.9, 0.1], np.float32)


def poses(n, theta, phi_end, radius=2.0):
    return np.asarray(jcircle_poses(n, radius=radius, theta=theta, phi=(0.0, phi_end)))[:, :3]


def sphere_render(c2w: np.ndarray, h: int, w: int, f: float):
    """A shaded unit-diameter sphere at the origin on white, seen from the
    pinhole camera c2w [3, 4] with focal f and a centred principal point:
    rgb [h, w, 3] and along-ray depth [h, w, 1], float32, computed in
    float64 with numpy."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs = np.stack([(xs - w / 2) / f, -(ys - h / 2) / f, -np.ones_like(xs)], -1)
    dirs = dirs @ c2w[:3, :3].astype(np.float64).T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3].astype(np.float64)
    b = dirs @ o
    disc = b * b - (o @ o - 0.25)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = o + dirs * t[..., None]
    shade = 0.3 + 0.7 * np.clip(normal[..., 2:3] + 0.5, 0.0, 1.0)
    rgb = np.where(hit[..., None], np.array([0.8, 0.3, 0.2]) * shade, 1.0)
    depth = np.where(hit, t, 3.0)[..., None]
    return rgb.astype(np.float32), depth.astype(np.float32)


def jax_render(cameras, index):
    rgb, depth = sphere_render(np.asarray(cameras.camera_to_worlds[index]), cameras.height, cameras.width,
                               float(cameras.fx[index]))
    return {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth)}


def port_render(cameras, index):
    rgb, depth = sphere_render(cameras.camera_to_worlds[index].numpy(), cameras.height, cameras.width,
                               float(cameras.fx[index]))
    return {"rgb": torch.from_numpy(rgb), "depth": torch.from_numpy(depth)}


def fake_diffuse(original, rendered, mask, condition):
    """The edit stand-in: the masked region painted green."""
    out = np.array(original)
    if mask is not None:
        out[mask[..., 0] > 0.5] = GREEN
    return out


GEN_CONFIG = dict(
    dataset_name="exp", downscale_factor=2, fx=FOCAL, fy=FOCAL, cx=W / 2, cy=H / 2, width=W, height=H, rows=2,
    cols=2, masking_mode="aabb", aabb_min=(-0.5, -0.5, -0.5), aabb_max=(0.5, 0.5, 0.5), mask_dilation=(5, 5),
)


def generators(tmp_path, **kw):
    """(JAX generator, port generator) with the same config, writing under
    tmp_path/jax and tmp_path/port."""
    out = []
    for side, mod, cfg_cls, diff_cls, render, extra in [
        ("jax", jgen, JDiffuserConfig, JDiffuser, jax_render, {}),
        ("port", tgen, DiffuserConfig, Diffuser, port_render, {"device": "cpu"}),
    ]:
        cfg = mod.DatasetGeneratorConfig(path=tmp_path / side, diffuser=cfg_cls(mode="custom"), **GEN_CONFIG)
        for key, val in kw.items():
            if key == "renderer":
                cfg.renderer = mod.RendererConfig(**val)
            else:
                setattr(cfg, key, val)
        out.append(mod.DatasetGenerator(cfg, np.eye(4)[:3], 1.0, lambda p: p, render,
                                        diffuser=diff_cls(cfg.diffuser, custom_fn=fake_diffuse), **extra))
    return out


def camera_pair(c2ws):
    n = len(c2ws)
    kw = lambda mk: dict(camera_to_worlds=mk(np.asarray(c2ws, np.float32)), fx=mk([FOCAL] * n),  # noqa: E731
                         fy=mk([FOCAL] * n), cx=mk([W / 2] * n), cy=mk([H / 2] * n), width=W, height=H)
    return (JCameras(**kw(lambda a: jnp.asarray(np.asarray(a, np.float32)))),
            Cameras(**kw(lambda a: torch.from_numpy(np.array(a, np.float32)))))


def png_arrays(root: Path):
    return {p.relative_to(root).as_posix(): load_rgb(p).astype(np.int32) for p in sorted(root.rglob("*.png"))}


def assert_same_dataset(jroot: Path, troot: Path) -> dict:
    """Every PNG of the schema in both, pixel for pixel within one level of
    8 bits, at most 5% of a file's values one level apart: the resizes
    agree to f32 rounding, and the [0, 1] -> uint8 rule truncates, so a
    value that is an exact multiple of 1/255 on one side can land one level
    lower on the other (measured: up to 1.43% of a 16 px cell of random
    photo pixels, where a 2x downscale averages whole levels);
    transforms.json equal, poses within 1e-6; config.yml loads into both."""
    jp, tp = png_arrays(jroot), png_arrays(troot)
    assert sorted(jp) == sorted(tp)
    worst = {}
    for name in jp:
        assert jp[name].shape == tp[name].shape, name
        diff = np.abs(jp[name] - tp[name])
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.05, (name, diff.max(), (diff > 0).mean())
        worst[name] = int(diff.max())
    jt = json.loads((jroot / "transforms.json").read_text())
    tt = json.loads((troot / "transforms.json").read_text())
    assert sorted(jt) == sorted(tt)
    for key in jt:
        if key != "frames":
            assert jt[key] == tt[key], key
    assert len(jt["frames"]) == len(tt["frames"])
    for jf, tf in zip(jt["frames"], tt["frames"]):
        assert sorted(jf) == sorted(tf)
        for key in jf:
            if key.endswith("transform_matrix"):
                np.testing.assert_allclose(tf[key], jf[key], rtol=0, atol=1e-6)
            else:
                assert jf[key] == tf[key], key
    for side in (jroot, troot):
        assert tcfg.load_yaml(tgen.DatasetGeneratorConfig, side / "config.yml").rows == GEN_CONFIG["rows"]
        assert jcfg.load_yaml(jgen.DatasetGeneratorConfig, side / "config.yml").cols == GEN_CONFIG["cols"]
    return worst


REF = dict(n=3, theta=60.0, phi_end=240.0)


@pytest.mark.parametrize("batch", [1, 4])
def test_generator_synthetic_matches_jax(tmp_path, batch):
    jg, tg = generators(tmp_path, generation_batch_size=batch)
    ref, syn = poses(**REF), poses(5, 75.0, 288.0)
    jout = jg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    tout = tg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    assert_same_dataset(jout, tout)
    t = json.loads((tout / "transforms.json").read_text())
    assert t["reference_indices"] == [0, 1, 2] and t["generated_indices"] == [3, 4, 5, 6, 7]
    assert len(tg.last_timings["view_s"]) == -(-5 // batch)
    edited = load_rgb(tout / "images" / "image_3.png")
    assert ((edited[..., 1] > 200) & (edited[..., 0] < 100)).sum() > 0  # the edit landed


def test_generator_original_dataset_matches_jax(tmp_path):
    """The per-view loop over original photos (prefetched decodes), the
    photos at another size than the generator's, so `_decode_original`
    resizes them (the JAX package through its native codec)."""
    jg, tg = generators(tmp_path, generation_batch_size=2)
    jcams, tcams = camera_pair(poses(3, 45.0, 120.0))
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        path = tmp_path / f"orig_{i}.png"
        save_array_png(rng.random((H + 8, W + 5, 3)).astype(np.float32), path)
        files.append(path)
    np.testing.assert_array_equal(tg._decode_original(files[0]), np.asarray(jg._decode_original(files[0])))
    ref = poses(**REF)
    jout = jg.generate_dataset(reference_camera_to_worlds=ref, original_cameras=jcams, original_filenames=files)
    tout = tg.generate_dataset(reference_camera_to_worlds=ref, original_cameras=tcams, original_filenames=files)
    assert_same_dataset(jout, tout)
    assert sorted(p.name for p in (tout / "originals").glob("*.png")) == ["image_3.png", "image_4.png", "image_5.png"]


def test_generator_merge_with_inverted_masks_matches_jax(tmp_path):
    jg, tg = generators(tmp_path)
    jcams, tcams = camera_pair(poses(2, 45.0, 90.0))
    originals = np.random.default_rng(1).random((2, H, W, 3)).astype(np.float32)
    ref, syn = poses(**REF), poses(2, 75.0, 180.0)
    kw = dict(reference_camera_to_worlds=ref, original_images=originals, synthetic_camera_to_worlds=syn,
              merge_with_original_dataset=True)
    jout = jg.generate_dataset(original_cameras=jcams, **kw)
    tout = tg.generate_dataset(original_cameras=tcams, **kw)
    assert_same_dataset(jout, tout)
    t = json.loads((tout / "transforms.json").read_text())
    assert t["is_combined"] is True and t["original_indices"] == [5, 6]
    mask = load_rgb(tout / "masks" / "mask_5.png")[..., 0]
    render_mask = load_rgb(tout / "masks" / "mask_0.png")[..., 0]
    assert mask.min() == 0 and mask.max() == 255 and render_mask.max() == 255  # inverted, not empty


def test_generator_shape_mode_matches_jax(tmp_path):
    """Shape mode: the bunny proxy ray-traced in both packages; the mask is
    where the mesh is in front of the NeRF's depth."""
    jg, tg = generators(tmp_path, masking_mode="shape",
                        renderer=dict(position=(0.0, 0.0, 0.45), rotation=(90.0, 0.0, 0.0), scale=(0.06,) * 3))
    ref, syn = poses(**REF), poses(2, 75.0, 180.0)
    jout = jg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    tout = tg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    assert_same_dataset(jout, tout)
    assert load_rgb(tout / "masks" / "mask_0.png").max() == 255


def test_generator_empty_mask_warning_matches_jax(tmp_path, capsys):
    jg, tg = generators(tmp_path, aabb_min=(5.0, 5.0, 5.0), aabb_max=(6.0, 6.0, 6.0))
    ref, syn = poses(**REF), poses(1, 75.0, 0.0)
    jout = jg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    jwarn = [line for line in capsys.readouterr().out.splitlines() if "EMPTY" in line]
    tout = tg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    twarn = [line for line in capsys.readouterr().out.splitlines() if "EMPTY" in line]
    assert twarn == jwarn and len(twarn) == 3
    assert_same_dataset(jout, tout)


def test_reference_sheet_and_cell_window_match_jax(tmp_path):
    """`generate_reference_sheet` in both packages, and `_cell_from_edited`
    on a bottom-right window of a sheet whose /8 padding puts the last cell
    in from the corner (2 x 3 cells of 20 x 18 px: 40 x 54, padded to 40 x 56)."""
    jg, tg = generators(tmp_path, cols=3, height=40, width=36, cy=20.0, cx=18.0)
    ref = poses(5, 60.0, 288.0)
    jcams, tcams = jg._cameras_from_poses(ref), tg._cameras_from_poses(ref)
    jout, tout = jg.generate_reference_sheet(jcams), tg.generate_reference_sheet(tcams)
    for a, b in zip(jout[:4], tout[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    for jr, tr in zip(jout[4], tout[4]):
        for key in jr:
            np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]), rtol=0, atol=1e-6, err_msg=key)
    lo = tg._layout()
    assert (lo.height, lo.width) == (40, 56)
    sheet = np.random.default_rng(2).random((lo.height, lo.width, 3)).astype(np.float32)
    window = sheet[-30:, -40:]
    for edited in (sheet, window):
        want = np.asarray(jg._cell_from_edited(jg._layout(), jnp.asarray(edited)))
        got = tg._cell_from_edited(lo, torch.from_numpy(edited)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, sheet[20:40, 36:54])


# ---------------------------------------------------------------------------
# Dataparser, loader, configs
# ---------------------------------------------------------------------------


def test_transform_poses_to_original_space_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((5, 3, 4)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    transform = np.concatenate([rot, rng.standard_normal((3, 1))], 1).astype(np.float32)
    got = tdp.transform_poses_to_original_space(p, transform, 0.37)
    np.testing.assert_array_equal(got, jdp.transform_poses_to_original_space(p, transform, 0.37))
    # it undoes the dataparser: scale the translation, then apply the transform
    back = np.einsum("ij,njk->nik", transform[:, :3], got)
    back[:, :, 3] += transform[:, 3]
    back[:, :, 3] *= 0.37
    np.testing.assert_allclose(back, p, rtol=0, atol=1e-5)


def test_previous_experiment_cameras_match_jax(tmp_path):
    _, tg = generators(tmp_path)
    ref, syn = poses(**REF), poses(2, 75.0, 180.0)
    out = tg.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    got = tdp.load_previous_experiment_cameras(out / "transforms.json")
    want = jdp.load_previous_experiment_cameras(out / "transforms.json")
    assert got["is_combined"] is want["is_combined"] is False
    for key in ("reference_camera_to_worlds", "synthetic_camera_to_worlds"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["reference_camera_to_worlds"], ref, rtol=0, atol=1e-6)
    parsed = tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=out))
    assert len(parsed.image_filenames) == 5 and parsed.dataparser_scale == 1.0


@pytest.mark.parametrize("src,dst", [((37, 53), (24, 24)), ((24, 24), (37, 53)), ((64, 48), (32, 24)),
                                     ((33, 17), (33, 18))])
def test_loader_resize_matches_jax(tmp_path, src, dst):
    """Images: bilinear, equal to the JAX loader's native codec byte for
    byte; masks: nearest, equal to its Pillow path."""
    rng = np.random.default_rng(sum(src + dst))
    img, msk = tmp_path / "i.png", tmp_path / "m.png"
    save_array_png(rng.random(src + (3,)).astype(np.float32), img)
    save_array_png(rng.random(src + (1,)).astype(np.float32), msk)
    (h, w) = dst
    np.testing.assert_array_equal(tdm.load_images([img], w, h), jdm.load_images([img], w, h))
    np.testing.assert_array_equal(tdm.load_masks([msk], w, h), jdm.load_masks([msk], w, h))


def test_config_yaml_across_packages(tmp_path):
    """A `config.yml` written by either package loads in the other: the
    generator's (which a previous experiment restores) and the trainer's."""
    from signerf_tpu.method_configs import signerf_method as jmethod
    from signerf_tpu.engine.trainer import SIGNeRFTrainerConfig as JTrainerConfig
    from signerf_tpu_torch.engine.trainer import SIGNeRFTrainerConfig
    from signerf_tpu_torch.method_configs import signerf_method

    jg = jgen.DatasetGeneratorConfig(rows=3, mask_dilation=(7, 9), manual_depth=(0.5, 1.5),
                                     renderer=jgen.RendererConfig(object_path="cube", scale=(0.2, 0.3, 0.4)),
                                     diffuser=JDiffuserConfig(prompt="a hat", seed=5))
    jcfg.save_yaml(jg, tmp_path / "j.yml")
    tg = tcfg.load_yaml(tgen.DatasetGeneratorConfig, tmp_path / "j.yml")
    assert tcfg.to_dict(tg) == jcfg.to_dict(jg)
    assert tg.mask_dilation == (7, 9) and tg.renderer.scale == (0.2, 0.3, 0.4) and tg.diffuser.prompt == "a hat"
    tcfg.save_yaml(tg, tmp_path / "t.yml")
    assert (tmp_path / "t.yml").read_text() == (tmp_path / "j.yml").read_text()
    assert jcfg.to_dict(jcfg.load_yaml(jgen.DatasetGeneratorConfig, tmp_path / "t.yml")) == jcfg.to_dict(jg)
    # the port's trainer config: every key is one of the JAX trainer's
    t = signerf_method()
    t.pipeline.dataset_generator.rows = 4
    tcfg.save_yaml(t, tmp_path / "trainer.yml")
    j = jcfg.load_yaml(JTrainerConfig, tmp_path / "trainer.yml")
    assert j.pipeline.dataset_generator.rows == 4 and j.pipeline.model.use_lpips is True
    back = tcfg.from_dict(SIGNeRFTrainerConfig, tcfg.to_dict(t))
    assert tcfg.to_yaml(back) == tcfg.to_yaml(t)
    # the JAX method's generator section loads into the port
    jm = jmethod()
    tcfg.from_dict(tgen.DatasetGeneratorConfig, jcfg.to_dict(jm.pipeline.dataset_generator))


def test_edit_flow_modules_import_no_jax():
    code = (
        "import sys, signerf_tpu_torch.generator, signerf_tpu_torch.generator.datasetgenerator, "
        "signerf_tpu_torch.export, signerf_tpu_torch.geometry.marching, signerf_tpu_torch.pipeline, "
        "signerf_tpu_torch.engine.trainer, signerf_tpu_torch.train; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'signerf_tpu')); print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_generator_defaults_match_jax():
    j, t = jgen.DatasetGeneratorConfig(), tgen.DatasetGeneratorConfig()
    for key in ("rows", "cols", "downscale_factor", "generation_batch_size", "lastcell_vae_window",
                "mask_dilation", "masking_mode", "additional_depth_radius"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.rows, t.cols, t.downscale_factor, t.generation_batch_size, t.lastcell_vae_window) == (2, 3, 2, 4, True)
    assert t.diffuser.mode == "torch_sdxl"
    assert tcfg.from_dict(tgen.RendererConfig, jcfg.to_dict(jgen.RendererConfig())) == tgen.RendererConfig()
