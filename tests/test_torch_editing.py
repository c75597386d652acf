"""The editing geometry on the CPU against the JAX package: the elliptical
structuring element (against cv2 and the JAX module), mask dilation, the
two mask/condition modes, the sheet functions, the proxy-mesh raster, OBJ
loading and posing, and the slice as a whole: the same converted NeRF
renders eight small views in both packages, then masks, conditions and the
composed reference sheet.

Inputs are made with numpy from a seed and handed to both frameworks.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.cameras.cameras import Cameras as JCameras
from signerf_tpu.cameras.poses import circle_poses as jcircle_poses
from signerf_tpu.editing import conditions as jcond
from signerf_tpu.editing import morphology as jmorph
from signerf_tpu.editing import sheet as jsheet
from signerf_tpu.engine.train_step import make_eval_render as jmake_eval_render
from signerf_tpu.geometry import obj as jobj
from signerf_tpu.geometry import primitives as jprim
from signerf_tpu.geometry import raster as jraster
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu.models.nerfacto import NerfactoModelConfig as JCfg
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.editing import conditions as cond
from signerf_tpu_torch.editing import morphology as morph
from signerf_tpu_torch.editing import sheet
from signerf_tpu_torch.engine.train_step import make_eval_render
from signerf_tpu_torch.geometry import obj, primitives, raster
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def j(a):
    return jnp.asarray(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# Morphology
# ---------------------------------------------------------------------------


def test_ellipse_kernel_equals_cv2_at_every_size():
    cv2 = pytest.importorskip("cv2")
    for w in range(1, 64):
        for h in range(1, 64):
            want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (w, h)).astype(np.float32)
            np.testing.assert_array_equal(morph.ellipse_kernel(w, h), want, err_msg=f"size {(w, h)}")


def test_ellipse_kernel_against_the_jax_module(monkeypatch):
    """Where cv2 is importable the JAX module returns cv2's element, which
    the port equals; its own fallback (taken without cv2) differs at even
    sizes: 119 of 2,500 pixels at the default (50, 50), none at odd sizes."""
    for size in [(50, 50), (10, 20), (7, 7), (2, 2), (1, 1), (3, 8)]:
        np.testing.assert_array_equal(morph.ellipse_kernel(*size), jmorph.ellipse_kernel(*size))
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    fallback = jmorph.ellipse_kernel.__wrapped__
    assert int((fallback(50, 50) != morph.ellipse_kernel(50, 50)).sum()) == 119
    assert int((fallback(10, 20) != morph.ellipse_kernel(10, 20)).sum()) == 41
    for size in [(7, 7), (13, 9), (51, 51)]:
        np.testing.assert_array_equal(fallback(*size), morph.ellipse_kernel(*size))


@pytest.mark.parametrize("size", [(50, 50), (10, 20), (7, 7), (2, 2), (1, 1)])
def test_dilate_matches_jax(size):
    rng = np.random.default_rng(sum(size))
    m = (rng.random((90, 120)) > 0.995).astype(np.float32)
    m[40:44, 60:70] = 1.0
    want = np.asarray(jmorph.dilate(j(m), size))
    got = morph.dilate(t(m), size)
    assert got.dtype == torch.float32 and got.shape == (90, 120)
    np.testing.assert_array_equal(got.numpy(), want)  # exact: sums of zeros and ones
    got3 = morph.dilate(t(m[..., None]), size)
    np.testing.assert_array_equal(got3.numpy(), np.asarray(jmorph.dilate(j(m[..., None]), size)))


# ---------------------------------------------------------------------------
# Masks and conditions
# ---------------------------------------------------------------------------


def depth_case(seed=0, h=40, w=48):
    rng = np.random.default_rng(seed)
    nerf = (1.5 + rng.random((h, w, 1))).astype(np.float32)
    mesh = np.zeros((h, w, 1), np.float32)
    mesh[10:30, 12:36] = (1.2 + 0.6 * rng.random((20, 24, 1))).astype(np.float32)
    return nerf, mesh


SHAPE_VARIANTS = {
    "default": dict(mask_dilation=(5, 5)),
    "inverse": dict(mask_dilation=(5, 5), inverse_mask=True),
    "manual_depth": dict(mask_dilation=(4, 6), manual_depth=(1.0, 2.5)),
    "no_dilation": dict(mask_dilation=None, additional_depth_radius=0.3),
    "empty": dict(mask_dilation=(5, 5)),
}


@pytest.mark.parametrize("variant", list(SHAPE_VARIANTS))
def test_shape_mask_condition_matches_jax(variant):
    nerf, mesh = depth_case()
    if variant == "empty":
        nerf = np.full_like(nerf, 0.5)  # the mesh is behind the NeRF everywhere
    kw = SHAPE_VARIANTS[variant]
    jm, jc = jcond.shape_mask_condition(j(nerf), j(mesh), jcond.MaskingConfig(masking_mode="shape", **kw))
    tm, tc = cond.shape_mask_condition(t(nerf), t(mesh), cond.MaskingConfig(masking_mode="shape", **kw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)  # the same f32 formula
    if variant == "empty":
        assert not tm.any() and not tc.any()
    else:
        assert tm.any() and bool(torch.isfinite(tc).all())


AABB_VARIANTS = {
    "default": dict(mask_dilation=(5, 5)),
    "inverse": dict(mask_dilation=(5, 5), inverse_mask=True),
    "manual_depth": dict(mask_dilation=(5, 5), manual_depth=(1.5, 2.5)),
    "combine_with_shape": dict(mask_dilation=(5, 5), combine_shape_with_depth=True),
    "empty": dict(mask_dilation=(5, 5), aabb_min=(5.0, 5.0, 5.0), aabb_max=(5.5, 5.5, 5.5)),
}


@pytest.mark.parametrize("variant", list(AABB_VARIANTS))
def test_aabb_mask_condition_matches_jax(variant):
    h, w = 40, 48
    poses = np.asarray(jcircle_poses(1, radius=2.0, theta=70.0, phi=(0.0, 0.0)))
    jcam = JCameras(camera_to_worlds=j(poses[:, :3]), fx=j([40.0]), fy=j([40.0]), cx=j([w / 2]),
                    cy=j([h / 2]), width=w, height=h)
    rb = jcam.generate_rays(camera_index=0)
    o, d = np.asarray(rb.origins), np.asarray(rb.directions)
    nerf, mesh = depth_case(seed=1, h=h, w=w)
    nerf = nerf * 0.8 + 0.2  # depths 1.4 to 2.2: across the box's interval
    rng = np.random.default_rng(2)
    color = rng.random((h, w, 3)).astype(np.float32)
    kw = {"aabb_min": (-0.6, -0.6, -0.6), "aabb_max": (0.6, 0.6, 0.6), **AABB_VARIANTS[variant]}
    jm, jc = jcond.aabb_mask_condition(j(nerf), j(o), j(d), jcond.MaskingConfig(**kw), mesh_depth=j(mesh),
                                       mesh_color=j(color))
    tm, tc = cond.aabb_mask_condition(t(nerf), t(o), t(d), cond.MaskingConfig(**kw), mesh_depth=t(mesh),
                                      mesh_color=t(color))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    if variant == "empty":
        assert not tm.any() and not tc.any()
    else:
        assert tm.any() and bool(torch.isfinite(tc).all())


# ---------------------------------------------------------------------------
# The sheet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((512, 512), (256, 256)), ((48, 40), (96, 80)), ((480, 640), (160, 213)),
                                     ((100, 60), (37, 91))])
def test_resizes_match_jax(src, dst):
    rng = np.random.default_rng(src[0] + dst[1])
    img = rng.random((*src, 3)).astype(np.float32)
    got = sheet.resize_bilinear(t(img), *dst)
    want = np.asarray(jsheet.resize_bilinear(j(img), *dst))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)  # measured 1.8e-7
    m = (rng.random((*src, 1)) > 0.5).astype(np.float32)
    got_m = sheet.resize_mask(t(m), *dst).numpy()
    want_m = np.asarray(jsheet.resize_mask(j(m), *dst))
    np.testing.assert_array_equal(got_m, want_m)  # no threshold flips on the CPU


def test_sheet_functions_match_jax():
    layout = sheet.SheetLayout(rows=3, cols=3, cell_height=14, cell_width=18, border=3)
    jlayout = jsheet.SheetLayout(rows=3, cols=3, cell_height=14, cell_width=18, border=3)
    assert (layout.height, layout.width, layout.last_index) == (jlayout.height, jlayout.width, jlayout.last_index)
    assert layout.height % 8 == 0 and layout.width % 8 == 0
    rng = np.random.default_rng(3)
    imgs = [rng.random((14, 18, 3)).astype(np.float32) for _ in range(8)]
    masks = [(rng.random((14, 18, 1)) > 0.5).astype(np.float32) for _ in range(8)]
    conds = [rng.random((14, 18, 1)).astype(np.float32) for _ in range(8)]
    got = sheet.compose_sheet(layout, [t(a) for a in imgs], [t(a) for a in masks], [t(a) for a in conds])
    want = jsheet.compose_sheet(jlayout, [j(a) for a in imgs], [j(a) for a in masks], [j(a) for a in conds])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    render, mask, cnd = rng.random((14, 18, 3)), rng.random((14, 18, 1)) > 0.5, rng.random((14, 18, 1))
    got_s = sheet.splice_last_cell(layout, got[0], got[2], t(render), t(mask), t(cnd))
    want_s = jsheet.splice_last_cell(jlayout, want[0], want[2], j(render), j(mask), j(cnd))
    for a, b in zip(got_s, want_s):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not torch.equal(got_s[0], got[0])  # the inputs are left as they were
    edited = rng.random((layout.height, layout.width, 3)).astype(np.float32)
    blend = sheet.blend_with_mask(t(edited), got[0], got[1])
    np.testing.assert_allclose(blend.numpy(), np.asarray(jsheet.blend_with_mask(j(edited), want[0], want[1])),
                               rtol=0, atol=1e-7)
    for a, b in zip(sheet.split_cells(layout, blend, 8), jsheet.split_cells(jlayout, j(blend.numpy()), 8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sheet.extract_last_cell(layout, got_s[0]).numpy(),
                                  np.asarray(jsheet.extract_last_cell(jlayout, want_s[0])))


# ---------------------------------------------------------------------------
# Proxy meshes and the raster
# ---------------------------------------------------------------------------


def test_primitives_obj_and_pose_match_jax(tmp_path):
    for name, args in [("cube", (1.0,)), ("icosphere", (2, 0.7)), ("bunny", (3,))]:
        for a, b in zip(getattr(primitives, name)(*args), getattr(jprim, name)(*args)):
            np.testing.assert_array_equal(a, b)
    verts, faces = primitives.bunny(2)
    primitives.save_obj(tmp_path / "bunny.obj", verts, faces)
    with open(tmp_path / "quad.obj", "w") as fh:  # a polygon, negative and v/vt/vn indices
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nf 1/1 2/1/1 3 4\nf -4 -2 -1\n")
    for path in (tmp_path / "bunny.obj", tmp_path / "quad.obj"):
        for a, b in zip(obj.load_obj(path), jobj.load_obj(path)):
            np.testing.assert_array_equal(a, b)
    pose = obj.object_pose_matrix((0.1, -0.2, 0.3), (10.0, 20.0, 30.0), (0.05, 0.06, 0.07))
    np.testing.assert_array_equal(pose, jobj.object_pose_matrix((0.1, -0.2, 0.3), (10.0, 20.0, 30.0),
                                                                (0.05, 0.06, 0.07)))
    np.testing.assert_array_equal(obj.transform_vertices(verts, pose), jobj.transform_vertices(verts, pose))
    with pytest.raises(ValueError):
        (tmp_path / "empty.obj").write_text("# nothing\n")
        obj.load_obj(tmp_path / "empty.obj")


@pytest.mark.parametrize("mesh", ["cube", "icosphere"])
def test_ray_mesh_depth_matches_jax(mesh):
    verts, faces = primitives.cube(1.0) if mesh == "cube" else primitives.icosphere(2, 0.6)
    rng = np.random.default_rng(4)
    n = 700  # not a multiple of the chunks: padded rays and triangles
    o = (rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 0.0, 2.5])).astype(np.float32)
    d = (rng.standard_normal((n, 3)) * 0.25 + np.array([0.0, 0.0, -1.0])).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jraster.ray_mesh_depth(j(o), j(d), j(verts), jnp.asarray(faces), tri_chunk=64, ray_chunk=256))
    got = raster.ray_mesh_depth(t(o), t(d), verts, faces, tri_chunk=64, ray_chunk=256).numpy()
    hit_w, hit_g = np.isfinite(want), np.isfinite(got)
    assert 0.2 < hit_w.mean() < 0.95  # hits and misses both
    # Rays grazing a triangle edge may flip (sums in another order):
    # measured 0 flips here.
    assert (hit_w != hit_g).mean() <= 0.005
    both = hit_w & hit_g
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=1e-6)


def cameras_pair(n, h, w, f):
    poses = np.asarray(jcircle_poses(n, radius=2.0, theta=70.0, phi=(0.0, 360.0 * (n - 1) / n)))
    kw = lambda mk: dict(camera_to_worlds=mk(poses[:, :3]), fx=mk([f] * n), fy=mk([f] * n),  # noqa: E731
                         cx=mk([w / 2] * n), cy=mk([h / 2] * n), width=w, height=h)
    return JCameras(**kw(j)), Cameras(**kw(t))


def test_mesh_depth_render_matches_jax():
    jcams, tcams = cameras_pair(3, 30, 40, 35.0)
    verts, faces = primitives.icosphere(2, 1.0)
    pose = obj.object_pose_matrix((0.0, 0.0, 0.0), (0.0, 30.0, 0.0), (0.05, 0.05, 0.05))
    verts = obj.transform_vertices(verts, pose).astype(np.float32)  # radius 0.5 at the origin
    for i in range(3):
        for znear, zfar in [(1e-4, 10.0), (1.7, 10.0), (1e-4, 1.6)]:
            jc, jd = jraster.mesh_depth_render(jcams, j(verts), jnp.asarray(faces), znear=znear, zfar=zfar,
                                               color=(0.2, 0.4, 0.6), camera_index=i)
            tc, td = raster.mesh_depth_render(tcams, verts, faces, znear=znear, zfar=zfar, color=(0.2, 0.4, 0.6),
                                              camera_index=i)
            assert tc.shape == (30, 40, 3) and td.shape == (30, 40, 1)
            jd, td = np.asarray(jd), td.numpy()
            agree = ((jd > 0) == (td > 0)).mean()
            assert agree >= 0.995, agree  # grazing rays only (measured 1.0)
            both = (jd > 0) & (td > 0)
            np.testing.assert_allclose(td[both], jd[both], rtol=1e-5)
            np.testing.assert_array_equal(tc.numpy()[both[..., 0]], np.asarray(jc)[both[..., 0]])
            if znear == 1e-4 and zfar == 10.0:
                assert 0.05 < (td > 0).mean() < 0.9 and bool((tc.numpy()[td[..., 0] == 0] == 1.0).all())
            else:  # the window cuts part of the sphere's depth range away
                assert (td > 0).mean() < (raster.mesh_depth_render(tcams, verts, faces, camera_index=i)[1] > 0)\
                    .float().mean()


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

SMALL = dict(max_res=32, hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
             num_nerf_samples_per_ray=4)
VIEWS, HW, FOCAL = 8, 24, 22.0


def test_reference_sheet_slice_matches_jax():
    """Eight 24 px views of the same converted NeRF in both packages, then
    AABB and proxy-mesh (`bunny(3)`, posed) masks and conditions, resized
    to 12 px cells and composed into a 3x3 sheet, as the dataset
    generator's reference sheet is built."""
    jmodel = JModel(JCfg(**SMALL), num_train_images=VIEWS)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3)))
    model = NerfactoModel(NerfactoModelConfig(**SMALL), num_train_images=VIEWS)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    jcams, tcams = cameras_pair(VIEWS, HW, HW, FOCAL)
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    verts, faces = primitives.bunny(3)
    verts = obj.transform_vertices(verts, obj.object_pose_matrix((0.0, -0.2, 0.0), (0.0, 45.0, 0.0),
                                                                 (0.08, 0.08, 0.08))).astype(np.float32)
    mcfg = dict(aabb_min=(-0.5, -0.5, -0.5), aabb_max=(0.5, 0.5, 0.5), mask_dilation=(5, 5))
    jrender, trender = jmake_eval_render(jmodel, chunk_size=256), make_eval_render(model, chunk_size=256)
    cell = HW // 2
    out = {"j": {k: [] for k in ("rgb", "aabb", "shape", "cells")}, "t": {k: [] for k in ("rgb", "aabb", "shape", "cells")}}
    for i in range(VIEWS):
        jrb = jcams.generate_rays(camera_index=i, aabb=j(aabb))
        trb = tcams.generate_rays(camera_index=i, aabb=t(aabb))
        jo = jrender(params, jrb.reshape((HW * HW,)), appearance_mode="mean")
        to = trender(trb.reshape((HW * HW,)), appearance_mode="mean")
        jrgb, jdepth = jo["rgb"].reshape(HW, HW, 3), jo["depth"].reshape(HW, HW, 1)
        trgb, tdepth = to["rgb"].reshape(HW, HW, 3), to["depth"].reshape(HW, HW, 1)
        jm, jc = jcond.aabb_mask_condition(jdepth, jrb.origins, jrb.directions, jcond.MaskingConfig(**mcfg))
        tm, tc = cond.aabb_mask_condition(tdepth, trb.origins, trb.directions, cond.MaskingConfig(**mcfg))
        _, jmesh = jraster.mesh_depth_render(jcams, j(verts), jnp.asarray(faces), camera_index=i)
        _, tmesh = raster.mesh_depth_render(tcams, verts, faces, camera_index=i)
        jsm, jsc = jcond.shape_mask_condition(jdepth, jmesh, jcond.MaskingConfig("shape", mask_dilation=(5, 5)))
        tsm, tsc = cond.shape_mask_condition(tdepth, tmesh, cond.MaskingConfig("shape", mask_dilation=(5, 5)))
        for key, side, rgb, m, c, sm in [("j", jsheet, jrgb, jm, jc, jsm), ("t", sheet, trgb, tm, tc, tsm)]:
            out[key]["rgb"].append(np.asarray(rgb))
            out[key]["aabb"].append((np.asarray(m), np.asarray(c)))
            out[key]["shape"].append(np.asarray(sm))
            out[key]["cells"].append((side.resize_bilinear(rgb, cell, cell), side.resize_mask(m, cell, cell),
                                      side.resize_bilinear(c, cell, cell)))
    jl = jsheet.SheetLayout(rows=3, cols=3, cell_height=cell, cell_width=cell)
    tl = sheet.SheetLayout(rows=3, cols=3, cell_height=cell, cell_width=cell)
    jsh = jsheet.compose_sheet(jl, *[[c[k] for c in out["j"]["cells"]] for k in range(3)])
    tsh = sheet.compose_sheet(tl, *[[c[k] for c in out["t"]["cells"]] for k in range(3)])

    # tests/test_torch_render.py's bound: rgb in [0, 1] within 0.02 (the kernels' f32
    # contract against JAX's bf16 XLA expression, through the resampling;
    # measured 1.0e-4).
    np.testing.assert_allclose(np.stack(out["t"]["rgb"]), np.stack(out["j"]["rgb"]), rtol=0, atol=0.02)
    np.testing.assert_allclose(tsh[0].numpy(), np.asarray(jsh[0]), rtol=0, atol=0.02)
    # Masks follow the median depth, which may step by one sample between
    # the frameworks where a ray's weights cross 0.5, and a dilation
    # spreads a flipped pixel: the share of agreeing pixels, per mode and on
    # the sheet (measured 1.0 for each).
    aabb_agree = np.mean([(a[0] == b[0]).mean() for a, b in zip(out["t"]["aabb"], out["j"]["aabb"])])
    shape_agree = np.mean([(a == b).mean() for a, b in zip(out["t"]["shape"], out["j"]["shape"])])
    sheet_agree = (tsh[1].numpy() == np.asarray(jsh[1])).mean()
    assert min(aabb_agree, shape_agree, sheet_agree) >= 0.97, (aabb_agree, shape_agree, sheet_agree)
    coverage = [float(m[0].mean()) for m in out["t"]["aabb"]]
    assert min(coverage) > 0.0 and max(coverage) < 1.0, coverage  # every view selects something
    assert min(float(m.mean()) for m in out["t"]["shape"]) > 0.0
    # Conditions where both masks agree: the depth windows come from the
    # selected depths, so a flipped pixel at a window's edge moves them
    # (measured 5.3e-5).
    for (tm, tc), (jm, jc) in zip(out["t"]["aabb"], out["j"]["aabb"]):
        assert np.isfinite(tc).all() and tc.min() >= 0.0 and tc.max() <= 1.0
        np.testing.assert_allclose(tc[tm == jm], jc[tm == jm], rtol=0, atol=0.05)
    assert tuple(tsh[0].shape) == (tl.height, tl.width, 3) == (40, 40, 3)  # 36 padded up to /8
    assert not tsh[1][2 * cell :, 2 * cell :].any()  # the last cell is left empty
