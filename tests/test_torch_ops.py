"""The port's small modules against their JAX counterparts: contraction,
SH, intersection, cameras and ray generation (with distortion), circle
poses, samplers, renderers and the transforms.json parser.

Inputs come from numpy with a seed; both sides get the same arrays.
Tolerances are f32 ones: the same operations in the same order agree to
a few ulps, and only where the order differs (a reduction, a matmul) is
the bound wider, as stated at the assert.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.cameras import cameras as jcam
from signerf_tpu.cameras import poses as jposes
from signerf_tpu.data import dataparser as jdp
from signerf_tpu.models import renderers as jren
from signerf_tpu.models import samplers as jsam
from signerf_tpu.ops import contraction as jcon
from signerf_tpu.ops import intersection as jint
from signerf_tpu.ops import sh as jsh
from signerf_tpu_torch.cameras import cameras as tcam
from signerf_tpu_torch.cameras import poses as tposes
from signerf_tpu_torch.data import dataparser as tdp
from signerf_tpu_torch.models import renderers as tren
from signerf_tpu_torch.models import samplers as tsam
from signerf_tpu_torch.ops import contraction as tcon
from signerf_tpu_torch.ops import intersection as tint
from signerf_tpu_torch.ops import sh as tsh

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-6)  # same f32 ops in the same order


def rng(seed=0):
    return np.random.default_rng(seed)


def j(x):
    return np.asarray(x)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_contraction():
    x = (rng().standard_normal((500, 3)) * 3).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, -1, 0.5], [1e-4, 40, -2]]
    np.testing.assert_allclose(tcon.contract(t(x)).numpy(), j(jcon.contract(jnp.asarray(x))), **F32)
    np.testing.assert_allclose(
        tcon.contract_to_unit(t(x)).numpy(), j(jcon.contract_to_unit(jnp.asarray(x))), **F32
    )
    np.testing.assert_allclose(
        tcon.contract(t(x), order=2).numpy(), j(jcon.contract(jnp.asarray(x), order=2)), **F32
    )


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encode(levels):
    d = rng(1).standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsh.sh_encode(t(d), levels).numpy(), j(jsh.sh_encode(jnp.asarray(d), levels)), **F32
    )


def test_intersections():
    r = rng(2)
    o = (r.standard_normal((400, 3)) * 2).astype(np.float32)
    d = r.standard_normal((400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    for got, want in zip(
        tint.intersect_with_aabb(t(o), t(d), t(aabb)),
        jint.intersect_with_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb)),
    ):
        np.testing.assert_allclose(got.numpy(), j(want), **F32)
    for got, want in zip(
        tint.intersect_with_sphere(t(o), t(d), [0.1, 0.0, -0.2], 1.3),
        jint.intersect_with_sphere(jnp.asarray(o), jnp.asarray(d), [0.1, 0.0, -0.2], 1.3),
    ):
        # sqrt of a difference of squares near tangency: 1e-5 absolute.
        np.testing.assert_allclose(got.numpy(), j(want), rtol=1e-5, atol=1e-5)


def test_circle_poses():
    got = tposes.circle_poses(5, radius=2.5, theta=60.0, phi=(10.0, 300.0)).numpy()
    want = j(jposes.circle_poses(5, radius=2.5, theta=60.0, phi=(10.0, 300.0)))
    np.testing.assert_allclose(got, want, **F32)


def camera_arrays(n=3, w=20, h=14, seed=3):
    r = rng(seed)
    c2w = np.asarray(jposes.circle_poses(n, radius=2.0, theta=65.0, phi=(0.0, 240.0)))[:, :3, :]
    c2w = c2w.astype(np.float32)
    return dict(
        camera_to_worlds=c2w,
        fx=(18 + r.random(n)).astype(np.float32),
        fy=(17 + r.random(n)).astype(np.float32),
        cx=(w / 2 + r.random(n) - 0.5).astype(np.float32),
        cy=(h / 2 + r.random(n) - 0.5).astype(np.float32),
        # non-zero k1..k4, p1, p2: undistortion runs its 10 Newton steps
        distortion_params=np.array(
            [[0.05, -0.02, 0.004, -0.001, 0.001, -0.0015]] * n, np.float32
        )
        * (1 + np.arange(n, dtype=np.float32)[:, None]),
    ), w, h


@pytest.mark.parametrize("camera_index", [0, 2])
def test_generate_rays_with_distortion(camera_index):
    arrays, w, h = camera_arrays()
    jc = jcam.Cameras(**{k: jnp.asarray(v) for k, v in arrays.items()}, width=w, height=h)
    tc = tcam.Cameras(**{k: t(v) for k, v in arrays.items()}, width=w, height=h)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    jr = jax.jit(lambda c: c.generate_rays(camera_index=camera_index, aabb=jnp.asarray(aabb)))(jc)
    tr = tc.generate_rays(camera_index=camera_index, aabb=t(aabb))
    assert tr.shape == (h, w)
    # Ten Newton steps and a 3x3 rotation (einsum vs sum of products):
    # errors of a few ulps, amplified by the slab test's 1/d near d = 0.
    for name in ("origins", "directions", "pixel_area", "nears", "fars"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), j(getattr(jr, name)), rtol=1e-4, atol=1e-5, err_msg=name
        )
    np.testing.assert_array_equal(tr.camera_indices.numpy(), j(jr.camera_indices))


def test_undistort_newton():
    r = rng(4)
    u = (r.random(200) - 0.5).astype(np.float32)
    v = (r.random(200) - 0.5).astype(np.float32)
    dist = np.array([0.1, -0.05, 0.01, 0.0, 0.002, -0.003], np.float32)
    got = tcam._undistort_newton(t(u), t(v), t(dist))
    want = jcam._undistort_newton(jnp.asarray(u), jnp.asarray(v), jnp.asarray(dist))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), j(b), rtol=1e-5, atol=1e-6)


def test_rescaled_cameras():
    arrays, w, h = camera_arrays()
    tc = tcam.Cameras(**{k: t(v) for k, v in arrays.items()}, width=w, height=h).rescaled(0.5)
    jc = jcam.Cameras(**{k: jnp.asarray(v) for k, v in arrays.items()}, width=w, height=h).rescaled(0.5)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), j(getattr(jc, name)), **F32)


def bundles(num_rays=64, seed=5):
    r = rng(seed)
    o = (r.standard_normal((num_rays, 3)) * 0.3).astype(np.float32)
    d = r.standard_normal((num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = (0.05 + r.random((num_rays, 1)) * 0.1).astype(np.float32)
    fars = (nears + 0.5 + r.random((num_rays, 1)) * 3).astype(np.float32)
    cam = np.zeros((num_rays, 1), np.int32)
    area = np.ones((num_rays, 1), np.float32)
    fields = dict(origins=o, directions=d, pixel_area=area, camera_indices=cam, nears=nears, fars=fars)
    return (
        jcam.RayBundle(**{k: jnp.asarray(v) for k, v in fields.items()}),
        tcam.RayBundle(**{k: t(v) for k, v in fields.items()}),
    )


def test_spacing_and_uniform_bins():
    jb, tb = bundles()
    js, jinv = jsam.make_spacing(jb.nears, jb.fars)
    ts, tinv = tsam.make_spacing(tb.nears, tb.fars)
    jbins = jsam.sample_uniform_bins(None, 64, 11)
    tbins = tsam.sample_uniform_bins(None, 64, 11)
    np.testing.assert_allclose(tbins.numpy(), j(jbins), **F32)
    np.testing.assert_allclose(ts(tbins).numpy(), j(js(jbins)), **F32)
    tt = t(np.linspace(0.05, 900.0, 64 * 11, dtype=np.float32).reshape(64, 11))
    np.testing.assert_allclose(tinv(tt).numpy(), j(jinv(jnp.asarray(tt.numpy()))), **F32)


@pytest.mark.parametrize("zeros", [False, True])
def test_sample_pdf_bins(zeros):
    """searchsorted brackets == the reference's masked reductions, with
    fixed bins and weights (some rays all-zero, some spiky)."""
    r = rng(6)
    num_rays, s = 48, 24
    bins = np.sort(r.random((num_rays, s + 1)).astype(np.float32), axis=-1)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    weights = r.random((num_rays, s)).astype(np.float32) ** 4
    if zeros:
        weights[: num_rays // 2] = 0.0
        weights[num_rays // 2 :, ::3] = 0.0
    got = tsam.sample_pdf_bins(None, t(bins), t(weights), 17).numpy()
    want = j(jsam.sample_pdf_bins(None, jnp.asarray(bins), jnp.asarray(weights), 17))
    assert got.shape == want.shape == (num_rays, 18)
    # The CDF is a cumsum of 24 f32 terms whose order XLA may change
    # (~24 ulps), and the interpolation divides by a CDF step: 1e-5.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(got, axis=-1) >= 0)


def test_sample_pdf_bins_jittered_is_monotone():
    """With a generator the two frameworks draw different uniforms, so the
    jittered path is checked for its invariants only."""
    r = rng(7)
    bins = np.linspace(0, 1, 33, dtype=np.float32)[None].repeat(8, 0)
    weights = r.random((8, 32)).astype(np.float32)
    g = torch.Generator().manual_seed(3)
    got = tsam.sample_pdf_bins(g, t(bins), t(weights), 9)
    assert got.shape == (8, 10)
    assert torch.all(got[:, 1:] >= got[:, :-1]) and got.min() >= 0 and got.max() <= 1


def test_render_weights_and_renderers():
    r = rng(8)
    dens = (r.random((40, 16)) * 3).astype(np.float32)
    dens[:5] = 0.0  # empty rays: median depth falls back to the last sample
    starts = np.cumsum(r.random((40, 16)).astype(np.float32) * 0.2, axis=-1)
    ends = starts + 0.05
    deltas = ends - starts
    rgbs = r.random((40, 16, 3)).astype(np.float32)
    w_t = tsam.render_weights(t(dens), t(deltas))
    w_j = jsam.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    # cumsum order may differ (XLA's is a tree reduction): 1e-5 relative.
    np.testing.assert_allclose(w_t.numpy(), j(w_j), rtol=1e-5, atol=1e-6)
    w = w_t.numpy()  # both renderers get the same weights from here on
    wt, wj = t(w), jnp.asarray(w)
    for bg in ("last_sample", "white", "black"):
        np.testing.assert_allclose(
            tren.render_rgb(wt, t(rgbs), bg).numpy(), j(jren.render_rgb(wj, jnp.asarray(rgbs), bg)),
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_allclose(tren.render_accumulation(wt).numpy(), j(jren.render_accumulation(wj)), **F32)
    np.testing.assert_allclose(
        tren.render_depth_expected(wt, t(starts), t(ends)).numpy(),
        j(jren.render_depth_expected(wj, jnp.asarray(starts), jnp.asarray(ends))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_array_equal(
        tren.render_depth_median(wt, t(starts), t(ends)).numpy(),
        j(jren.render_depth_median(wj, jnp.asarray(starts), jnp.asarray(ends))),
    )


def test_proposal_sample_fixed_density():
    """The whole proposal driver with analytic density fields (a blob)."""
    jb, tb = bundles(num_rays=32, seed=9)

    def blob_np(p, xp):
        return 5.0 * xp.exp(-((p**2).sum(-1)) * 4.0)

    jfns = [lambda p: blob_np(p, jnp)] * 2
    tfns = [lambda p: blob_np(p, torch)] * 2
    js, jw, jl = jax.jit(lambda b: jsam.proposal_sample(None, b, jfns, (12, 8), 6))(jb)
    ts, tw, tl = tsam.proposal_sample(None, tb, tfns, (12, 8), 6)
    # Three rounds of resampling: f32 noise grows through exp/cumsum; 1e-4.
    np.testing.assert_allclose(ts.starts.numpy(), j(js.starts), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.ends.numpy(), j(js.ends), rtol=1e-4, atol=1e-5)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), j(b), rtol=1e-4, atol=1e-5)
    assert [s.num_samples for s in tl] == [12, 8]


def write_transforms(root, w=16, h=12, n=3, distort=True):
    from signerf_tpu_torch.utils.images import save_array_png

    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    poses = np.asarray(jposes.circle_poses(n, radius=3.0, theta=60.0, phi=(0.0, 200.0)))
    frames = []
    for i in range(n):
        save_array_png(np.full((h, w, 3), 0.5, np.float32), root / "images" / f"f{i}.png")
        frames.append({"file_path": f"images/f{i}.png", "transform_matrix": poses[i].tolist()})
    meta = {"fl_x": 14.0, "fl_y": 13.0, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "frames": frames}
    if distort:
        meta.update(k1=0.01, k2=-0.002, p1=0.0005)
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("orientation", ["up", "pca", "none"])
def test_parse_transforms_matches_jax(tmp_path, orientation):
    root = write_transforms(tmp_path / "scene")
    jout = jdp.parse_transforms(jdp.SIGNeRFDataParserConfig(data=root, orientation_method=orientation))
    tout = tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=root, orientation_method=orientation))
    assert tout.image_filenames == jout.image_filenames
    assert (tout.cameras.width, tout.cameras.height) == (jout.cameras.width, jout.cameras.height)
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "distortion_params"):
        np.testing.assert_allclose(
            getattr(tout.cameras, name).numpy(), np.asarray(getattr(jout.cameras, name)), **F32
        )
    np.testing.assert_allclose(tout.dataparser_transform, jout.dataparser_transform, **F32)
    assert tout.dataparser_scale == pytest.approx(jout.dataparser_scale)
    np.testing.assert_array_equal(tout.scene_box_aabb, jout.scene_box_aabb)


def test_parse_transforms_png_dims_without_wh(tmp_path):
    """Without w/h in transforms.json the size comes from the PNG header."""
    from signerf_tpu_torch.utils.images import png_dims

    root = write_transforms(tmp_path / "scene", w=30, h=20, n=2, distort=False)
    assert png_dims(root / "images" / "f0.png") == (30, 20)
    meta = json.loads((root / "transforms.json").read_text())
    for f in meta["frames"]:
        f["w"], f["h"] = 30, 20
    del meta["w"], meta["h"]
    (root / "transforms.json").write_text(json.dumps(meta))
    tout = tdp.parse_transforms(tdp.SIGNeRFDataParserConfig(data=root))
    assert (tout.cameras.width, tout.cameras.height) == (30, 20)
    assert tout.metadata["downscale_factor"] == 1


def test_png_writer_round_trip(tmp_path):
    from PIL import Image

    from signerf_tpu.utils.images import _to_uint8
    from signerf_tpu_torch.utils.images import save_array_png, to_uint8

    a = rng(10).random((9, 7, 3)).astype(np.float32)
    a[0, 0] = [np.nan, np.inf, -1.0]
    np.testing.assert_array_equal(to_uint8(a), _to_uint8(a))  # the reference's rule
    save_array_png(a, tmp_path / "rgb.png")
    save_array_png(a[..., :1], tmp_path / "gray.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), to_uint8(a))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "gray.png")), to_uint8(a)[..., 0])


def test_config_overrides_match_reference():
    from signerf_tpu import config as jconfig
    from signerf_tpu.models.nerfacto import NerfactoModelConfig as JCfg
    from signerf_tpu_torch import config as tconfig
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig as TCfg

    argv = [
        "--max-res", "32", "--num-proposal-samples-per-ray=[8, 6]",
        "--proposal-net-args-list", '[{"max_res": 64}, {"max_res": 96, "hidden_dim": 8}]',
        "--use-appearance-embedding", "false",
    ]
    assert tconfig.parse_cli_overrides(argv) == jconfig.parse_cli_overrides(argv)
    got = tconfig.apply_overrides(TCfg(), tconfig.parse_cli_overrides(argv))
    want = jconfig.apply_overrides(JCfg(), jconfig.parse_cli_overrides(argv))
    for f in ("max_res", "num_proposal_samples_per_ray", "use_appearance_embedding"):
        assert getattr(got, f) == getattr(want, f)
    assert [a.max_res for a in got.proposal_net_args_list] == [64, 96]
    assert got.proposal_net_args_list[1].hidden_dim == 8
    with pytest.raises(KeyError):
        tconfig.apply_overrides(TCfg(), {"no_such_knob": 1})
