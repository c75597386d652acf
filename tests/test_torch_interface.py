"""The port's interface (Generation API, web viewer, overlays) on the CPU
against the JAX package's, at 24 px on tests/test_pipeline_e2e.py's scene
with the `custom` fake diffuser.

Tolerances: the overlays are a copy of JAX's numpy code and equal it bit
for bit; poses and the scene manipulation within 1e-6; the viewer's render
on the same (converted) weights within 0.02 on RGB, the render tests'
bound. Then the whole HTTP surface of the port's server, `/generate` until
the refinement completes with the edit landed; that no viewer render
overlaps an optimizer step or the dataset exchange (the trainer's
`train_lock`); the writer's GLOBAL_BUFFER; and that the
interface imports nothing of JAX.
"""

import base64
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.cameras import poses as jposes
from signerf_tpu.diffusion.diffuser import Diffuser as JDiffuser
from signerf_tpu.engine.trainer import SIGNeRFTrainer as JTrainer
from signerf_tpu.interface import overlay as joverlay
from signerf_tpu.interface.api import GenerationInterface as JInterface
from signerf_tpu.interface.app import ViewerServer as JViewer
from signerf_tpu_torch.cameras import poses as tposes
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.diffusion.diffuser import Diffuser
from signerf_tpu_torch.engine import optimizers, writer
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
from signerf_tpu_torch.interface import GenerationInterface
from signerf_tpu_torch.interface import app
from signerf_tpu_torch.interface import overlay
from signerf_tpu_torch.interface.app import ViewerServer
from signerf_tpu_torch.utils.images import decode_png, encode_png, save_array_png
from tests.test_pipeline_e2e import EDIT_COLOR, EDIT_HI, EDIT_LO, N_CAMS, fake_diffuse
from tests.test_pipeline_e2e import tiny_trainer_config as jax_trainer_config
from tests.test_pipeline_e2e import write_tiny_dataset
from tests.test_torch_edit_flow_cli import render_view, tiny_trainer_config

torch.set_num_threads(2)

OVERLAYS = {"jax": joverlay, "port": overlay}


def port_trainer(data, out) -> SIGNeRFTrainer:
    cfg = tiny_trainer_config(data, out)
    trainer = SIGNeRFTrainer(cfg, "cpu")
    trainer.setup(diffuser=Diffuser(cfg.pipeline.dataset_generator.diffuser, custom_fn=fake_diffuse))
    return trainer


# ---------------------------------------------------------------------------
# Overlays: tests/test_interface.py's TestOverlay on both copies
# ---------------------------------------------------------------------------


def orbit_cam(size=64, yaw=30.0):
    pose = tposes.circle_poses(1, radius=2.0, theta=55.0, phi=(yaw, yaw)).numpy()[0, :3, :]
    return {"c2w": pose, "fx": size * 1.2, "fy": size * 1.2, "cx": size / 2, "cy": size / 2}


def both(fn):
    """fn(overlay module) on both copies; the results equal bit for bit."""
    want, got = fn(joverlay), fn(overlay)
    for a, b in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(b, a)
    return got


def test_project_center_lands_on_principal_point():
    cam = orbit_cam()
    xy, depth = both(lambda m: m.project_points(np.zeros((1, 3)), cam["c2w"], cam["fx"], cam["fy"], cam["cx"],
                                                cam["cy"]))
    assert depth[0] > 0
    np.testing.assert_allclose(xy[0], [cam["cx"], cam["cy"]], atol=1e-5)


def test_point_behind_camera_culled():
    cam = orbit_cam()
    behind = cam["c2w"][:3, 3] + cam["c2w"][:3, 2] * 1.0  # +z = backward
    segs = np.asarray([[behind, behind + 0.01]])
    out = both(lambda m: m.draw_segments(np.zeros((64, 64, 3), np.float32), segs, (1, 0, 0), cam["c2w"], cam["fx"],
                                         cam["fy"], cam["cx"], cam["cy"]))
    assert out.sum() == 0.0


def test_aabb_segments_are_twelve_edges():
    segs = both(lambda m: m.aabb_segments((-1, -2, -3), (1, 2, 3)))
    assert segs.shape == (12, 2, 3)
    lens = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1)
    assert sorted(np.unique(np.round(lens, 5))) == [2.0, 4.0, 6.0]


def test_compose_overlays_draws_box_and_every_element():
    from signerf_tpu_torch.geometry import primitives

    cam = orbit_cam()
    scene = {"train_poses": None, "reference_poses": None, "synthetic_poses": None,
             "aabb": ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3)), "shape": None}
    out = both(lambda m: m.compose_overlays(np.zeros((64, 64, 3), np.float32), cam, scene, {"aabb": True}))
    assert out.sum() > 0
    lit = out[out.sum(-1) > 0]
    np.testing.assert_allclose(lit.mean(0), np.asarray(overlay.COLOR_AABB) * 0.9, atol=0.05)
    # every element at once over a noisy frame
    ring = tposes.circle_poses(5, radius=1.5, theta=60.0, phi=(0.0, 288.0)).numpy()[:, :3]
    verts, faces = primitives.bunny(2)
    scene = {"train_poses": ring, "reference_poses": ring[:3] * 0.9, "synthetic_poses": ring[2:],
             "aabb": ((-0.3, -0.2, -0.1), (0.3, 0.2, 0.4)), "shape": {"verts": verts * 0.5, "faces": faces}}
    show = dict.fromkeys(("train", "reference", "synthetic", "aabb", "shape"), True)
    rgb = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    out = both(lambda m: m.compose_overlays(rgb, cam, scene, show))
    assert not np.array_equal(out, rgb)


def test_frustum_segments_shape():
    segs = both(lambda m: m.frustums_for_poses(np.tile(np.eye(4)[:3], (5, 1, 1))))
    assert segs.shape == (5 * 9, 2, 3)


def test_pixel_drag_is_camera_plane():
    cam = orbit_cam()
    point = np.zeros(3)
    args = (cam["c2w"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    delta = both(lambda m: m.pixel_drag_to_world(10.0, 0.0, cam["c2w"], cam["fx"], cam["fy"], point))
    xy0, _ = overlay.project_points(point[None], *args)
    xy1, _ = overlay.project_points((point + delta)[None], *args)
    np.testing.assert_allclose(xy1[0] - xy0[0], [10.0, 0.0], atol=1e-3)
    delta_y = both(lambda m: m.pixel_drag_to_world(0.0, 7.0, cam["c2w"], cam["fx"], cam["fy"], point))
    xy2, _ = overlay.project_points((point + delta_y)[None], *args)
    np.testing.assert_allclose(xy2[0] - xy0[0], [0.0, 7.0], atol=1e-3)


# ---------------------------------------------------------------------------
# Poses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed, size, radius, theta, phi, position, target",
    [
        (0, 60, 1.0, (0.0, 90.0), (0.0, 360.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        (3, 17, 2.5, (20.0, 70.0), (-45.0, 135.0), (0.1, -0.2, 0.3), (0.05, 0.0, -0.1)),
    ],
)
def test_random_sphere_poses_on_jax_draws(seed, size, radius, theta, phi, position, target):
    """JAX's two uniform draws fed through the port's seam give JAX's poses."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jposes.random_sphere_poses(key, size, radius=radius, theta=theta, phi=phi,
                                                 position=position, target=target))
    k_theta, k_phi = jax.random.split(key)
    draws = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (size,)))) for k in (k_theta, k_phi))
    got = tposes.random_sphere_poses(size, radius=radius, theta=theta, phi=phi, position=position, target=target,
                                     uniforms=draws)
    assert got.shape == (size, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # without the seam: the generator's draws, on the cap
    a = tposes.random_sphere_poses(size, radius, theta, phi, position, target, generator=torch.Generator().manual_seed(1))
    b = tposes.random_sphere_poses(size, radius, theta, phi, position, target, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    rel = a[:, :3, 3] - torch.tensor(position)
    np.testing.assert_allclose(rel.norm(dim=-1).numpy(), radius, rtol=1e-5)
    polar = torch.rad2deg(torch.arccos((rel[:, 2] / radius).clamp(-1, 1)))
    assert bool(((polar >= theta[0] - 1e-3) & (polar <= theta[1] + 1e-3)).all())


# ---------------------------------------------------------------------------
# The Generation API and the viewer's render against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ifaces(tmp_path_factory):
    """Both packages' interfaces over trainers of one tiny dataset, the port's
    model holding JAX's weights (perturbed by seeded noise, so that the
    views have structure)."""
    tmp = tmp_path_factory.mktemp("iface")
    data = write_tiny_dataset(tmp / "data")
    jcfg = jax_trainer_config(data, tmp / "jax")
    jtrainer = JTrainer(jcfg)
    jtrainer.setup(diffuser=JDiffuser(jcfg.pipeline.dataset_generator.diffuser, custom_fn=fake_diffuse))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda x: (np.asarray(x) + rng.normal(0, 0.3, x.shape)).astype(np.float32),
                                    jtrainer.state.params)
    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    trainer = port_trainer(data, tmp / "port")
    trainer.pipeline.model.load_state_dict(state_dict_from_jax(params), strict=True)
    return JInterface(jtrainer), GenerationInterface(trainer)


def assert_same_scene(j, t):
    sj, st = j.scene_elements(), t.scene_elements()
    assert sorted(sj) == sorted(st)
    for key in ("train_poses", "reference_poses", "synthetic_poses"):
        assert (sj[key] is None) == (st[key] is None), key
        if sj[key] is not None:
            np.testing.assert_allclose(st[key], np.asarray(sj[key]), rtol=0, atol=1e-6, err_msg=key)
    if sj["aabb"] is None:
        assert st["aabb"] is None
    else:
        np.testing.assert_allclose(np.asarray(st["aabb"]), np.asarray(sj["aabb"]), rtol=0, atol=1e-6)
    assert (sj["shape"] is None) == (st["shape"] is None)
    if sj["shape"] is not None:
        np.testing.assert_array_equal(st["shape"]["faces"], sj["shape"]["faces"])
        np.testing.assert_allclose(st["shape"]["verts"], sj["shape"]["verts"], rtol=0, atol=1e-6)
    tc, jc = t.gen_config, j.gen_config
    assert (tc.masking_mode, tc.inverse_mask) == (jc.masking_mode, jc.inverse_mask)
    for cfg_t, cfg_j, key in [(tc, jc, "aabb_min"), (tc, jc, "aabb_max"), (tc.renderer, jc.renderer, "position"),
                              (tc.renderer, jc.renderer, "rotation"), (tc.renderer, jc.renderer, "scale")]:
        np.testing.assert_allclose(getattr(cfg_t, key), getattr(cfg_j, key), rtol=0, atol=1e-6, err_msg=key)
    assert t.circle_params.keys() == j.circle_params.keys()
    for key, val in j.circle_params.items():
        np.testing.assert_allclose(t.circle_params[key], val, rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kw", [dict(), dict(radius=2.0, theta=60.0),
                                dict(radius=1.3, theta=40.0, phi_range=(30.0, 200.0), position=(0.1, 0.2, -0.3),
                                     target=(0.0, 0.1, 0.2))])
def test_reference_circle_matches_jax(ifaces, kw):
    j, t = ifaces
    got = t.set_reference_circle(**kw)
    want = np.asarray(j.set_reference_circle(**kw))
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (3, 3, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="rows\\*cols-1 = 3"):
        t.set_reference_poses(np.zeros((5, 3, 4)))


def test_scene_elements_match_jax(ifaces):
    j, t = ifaces
    for iface in ifaces:
        iface.set_reference_circle(radius=2.0, theta=60.0)
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4), inverse_mask=False)
    assert_same_scene(j, t)
    assert t.scene_elements()["train_poses"].shape == (N_CAMS, 3, 4)
    for shape in ("bunny", "icosphere", "cube", "missing.obj"):
        for iface in ifaces:
            iface.set_selection_shape(shape, position=(0.1, 0.0, 0.2), rotation=(90.0, 0.0, 30.0),
                                      scale=(0.2, 0.3, 0.4))
        assert_same_scene(j, t)
    assert t.scene_elements()["shape"] is None  # the missing file
    for iface in ifaces:  # the synthetic sphere: each package its own draws
        iface.set_dataset_cameras(mode="synthetic", count=7, radius=2.0)
    assert t.use_synthetic and t.scene_elements()["synthetic_poses"].shape == (7, 3, 4)
    t.set_dataset_cameras(mode="original")
    assert not t.use_synthetic and t.scene_elements()["synthetic_poses"] is None
    for iface in ifaces:
        iface.set_dataset_cameras(mode="original")
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))


def test_nudge_matches_jax(ifaces):
    j, t = ifaces
    steps = [
        ("aabb", dict(translate=(0.1, 0.0, 0.0))),
        ("aabb", dict(scale=2.0)),
        ("aabb", dict(translate=(-0.05, 0.2, 0.03), scale=0.7)),
        ("shape", dict(translate=(0.0, 0.2, 0.0), scale=1.5, rotate_deg=(0, 0, 90))),
        ("shape", dict(translate=(0.1, -0.1, 0.05), rotate_deg=(15, 0, -30))),
        ("reference", dict(translate=(0.5, 0.0, 0.0))),
        ("reference", dict(translate=(0.0, -0.2, 0.1), scale=1.25)),
    ]
    for iface in ifaces:
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
        iface.set_selection_shape("bunny", position=(0.0, 0.0, 0.0), scale=(0.1, 0.1, 0.1))
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
        iface.set_reference_circle(radius=2.0, theta=60.0)
    for element, kw in steps:
        for iface in ifaces:
            iface.nudge(element, **kw)
        assert_same_scene(j, t)
    with pytest.raises(ValueError, match="unknown scene element"):
        t.nudge("nope")
    for iface in ifaces:
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))


def test_drag_matches_jax(ifaces):
    j, t = ifaces
    for iface in ifaces:
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
        iface.set_selection_shape("cube", position=(0.1, 0.0, 0.0))
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
        iface.set_reference_circle(radius=2.0, theta=60.0)
    jcam = JViewer(j, port=0)._orbit_cam(20.0, 55.0, 2.0, 128)
    tcam = ViewerServer(t, port=0)._orbit_cam(20.0, 55.0, 2.0, 128)
    np.testing.assert_allclose(tcam["c2w"], np.asarray(jcam["c2w"]), rtol=0, atol=1e-6)
    for element, dx, dy in [("aabb", 10.0, 0.0), ("aabb", -3.0, 7.5), ("shape", 4.0, -2.0), ("reference", 6.0, 3.0)]:
        j.drag(element, dx, dy, jcam)
        t.drag(element, dx, dy, tcam)
        assert_same_scene(j, t)
    extent = np.asarray(t.gen_config.aabb_max) - np.asarray(t.gen_config.aabb_min)
    np.testing.assert_allclose(extent, 0.8, atol=1e-9)  # a drag moves, never scales
    with pytest.raises(ValueError, match="unknown scene element"):
        t.drag("nope", 1.0, 1.0, tcam)
    for iface in ifaces:
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))


def test_render_view_matches_jax(ifaces):
    """`_render_view` of both viewers on the same weights, paused (the size
    asked), without and with overlays."""
    j, t = ifaces
    for iface in ifaces:
        iface.trainer.training_state = "paused"
        iface.set_reference_circle(radius=2.0, theta=60.0)
        iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    jv, tv = JViewer(j, port=0), ViewerServer(t, port=0)
    for yaw, show in [(30.0, None), (120.0, None),
                      (30.0, {"train": True, "reference": True, "aabb": True, "synthetic": False, "shape": False})]:
        want = np.asarray(jv._render_view(yaw, 60.0, 2.0, 24, show=show))
        timings = {}
        got = tv._render_view(yaw, 60.0, 2.0, 24, show=show, timings=timings)
        assert got.shape == (24, 24, 3) and got.dtype == np.float32
        assert want.std() > 0.02  # the views have structure
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
        assert set(timings) == {"lock_s", "render_s"} and timings["render_s"] > 0
    assert writer.GLOBAL_BUFFER["vis_rays_per_sec"] > 0


# ---------------------------------------------------------------------------
# The HTTP surface of the port's server
# ---------------------------------------------------------------------------


def http(url, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, r.read()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server over a trainer trained 100 steps (port 0)."""
    tmp = tmp_path_factory.mktemp("served")
    trainer = port_trainer(write_tiny_dataset(tmp / "data"), tmp / "out")
    for _ in range(4):
        trainer.train_iteration()
    iface = GenerationInterface(trainer)
    server = ViewerServer(iface, port=0)
    httpd = server.start_background()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", iface, server
    httpd.shutdown()
    httpd.server_close()


def test_http_page_state_and_not_found(served):
    base, iface, _ = served
    status, headers, body = http(base + "/")
    assert status == 200 and headers["Content-Type"] == "text/html" and b"SIGNeRF-TPU viewer" in body
    state = json.loads(http(base + "/state")[2])
    assert state["training_state"] == "paused" and state["step"] == 100 and isinstance(state["metrics"], dict)
    for req in (lambda: http(base + "/nope"), lambda: http(base + "/nope", {})):
        with pytest.raises(urllib.error.HTTPError) as err:
            req()
        assert err.value.code == 404


def test_http_events_push_on_a_state_flip(served):
    base, iface, _ = served

    def next_event(r):
        line = r.readline()
        while not line.startswith(b"data: "):
            line = r.readline()
        return json.loads(line[len(b"data: "):])

    with urllib.request.urlopen(base + "/events", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        first = next_event(r)
        assert first["training_state"] == "paused" and first["step"] == 100
        iface.trainer.training_state = "training"
        try:
            assert next_event(r)["training_state"] == "training"
        finally:
            iface.trainer.training_state = "paused"


def test_http_render(served, monkeypatch):
    """PNGs decoded by the port's own decoder: at the size asked while
    paused, with overlays, and at the throttled size while training."""
    base, iface, server = served
    iface.set_reference_circle(radius=2.0, theta=60.0)
    status, headers, body = http(base + "/render?yaw=30&pitch=60&radius=2.0&size=24")
    img = decode_png(body)
    assert status == 200 and headers["Content-Type"] == "image/png" and img.shape == (24, 24, 3)
    spans = dict(s.split(";dur=") for s in headers["Server-Timing"].split(", "))
    assert sorted(spans) == ["lock", "png", "render"] and all(float(v) >= 0 for v in spans.values())
    plain = server._render_view(30.0, 60.0, 2.0, 24)
    np.testing.assert_array_equal(img, decode_png(encode_png(plain)))
    over = decode_png(http(base + "/render?yaw=30&pitch=60&radius=2.0&size=24&train=1&reference=1&aabb=1")[2])
    assert over.shape == (24, 24, 3) and not np.array_equal(over, img)
    # the throttle: 128 px at most before the first rays/s sample, then
    # sqrt(rays/s x 0.15 / 2 fps) px, never below 64
    monkeypatch.setattr(iface.trainer, "training_state", "training")
    monkeypatch.delitem(writer.GLOBAL_BUFFER, "train_rays_per_sec", raising=False)
    assert server.render_size(512) == 128 and server.render_size(24) == 24
    monkeypatch.setitem(writer.GLOBAL_BUFFER, "train_rays_per_sec", 1e6)
    assert server.render_size(512) == int(np.sqrt(1e6 * 0.15 / 2.0)) == 273
    monkeypatch.setitem(writer.GLOBAL_BUFFER, "train_rays_per_sec", 2e4)
    assert server.render_size(512) == 64
    assert decode_png(http(base + "/render?size=512")[2]).shape == (64, 64, 3)


def test_throttled_size_is_render_size_at_a_given_rate(served, monkeypatch):
    """`throttled_size(size, rate)` is what `render_size` gives while training
    runs at that rate, and paused renders are not throttled."""
    _, iface, server = served
    assert server.throttled_size(512, 0.0) == 128 and server.throttled_size(24, 0.0) == 24
    assert server.throttled_size(512, 1e6) == 273 and server.throttled_size(512, 2e4) == 64
    assert server.throttled_size(24, 1e6) == 24
    monkeypatch.setattr(iface.trainer, "training_state", "training")
    for rate in (3e4, 5.17e5, 1e6, 1e8):
        monkeypatch.setitem(writer.GLOBAL_BUFFER, "train_rays_per_sec", rate)
        assert server.render_size(512) == server.throttled_size(512, rate)
    monkeypatch.setattr(iface.trainer, "training_state", "paused")
    assert server.render_size(512) == 512


def test_http_scene_params_and_train(served):
    base, iface, _ = served
    iface.set_reference_circle(radius=2.0, theta=60.0)
    iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    s = json.loads(http(base + "/scene")[2])
    assert s["masking_mode"] == "aabb" and len(s["reference_poses"]) == 3 and len(s["train_poses"]) == N_CAMS
    assert s["aabb"] == [[-0.4, -0.4, -0.4], [0.4, 0.4, 0.4]] and s["shape"] is None
    iface.set_selection_shape("bunny", position=(0.1, 0.0, 0.0))
    s = json.loads(http(base + "/scene")[2])
    assert s["aabb"] is None and s["shape"]["num_verts"] > 100
    np.testing.assert_allclose(s["shape"]["center"], np.asarray(iface.scene_elements()["shape"]["verts"]).mean(0))
    iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    assert json.loads(http(base + "/params", {"prompt": "from http", "num_inference_steps": 5})[2]) == {"ok": True}
    assert iface.gen_config.diffuser.prompt == "from http"
    assert iface.trainer.pipeline.dataset_generator.diffuser.config.num_inference_steps == 5
    for state in ("training", "paused"):
        assert json.loads(http(base + "/train", {"state": state})[2]) == {"training_state": state}
        assert iface.trainer.training_state == state


def test_http_nudge_drag_and_bad_element(served):
    base, iface, _ = served
    iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    assert http(base + "/nudge", {"element": "aabb", "translate": [0.1, 0, 0]})[0] == 200
    np.testing.assert_allclose(iface.gen_config.aabb_min, (-0.3, -0.4, -0.4))
    iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    drag = {"element": "aabb", "dx_px": 8.0, "dy_px": 0.0, "yaw": 30.0, "pitch": 55.0, "radius": 2.0, "size": 128}
    assert http(base + "/drag", drag)[0] == 200
    center = 0.5 * (np.asarray(iface.gen_config.aabb_min) + np.asarray(iface.gen_config.aabb_max))
    assert np.linalg.norm(center) > 0.005
    iface.set_selection_aabb((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
    for path, body in [("/nudge", {"element": "nope"}), ("/nudge", {}), ("/drag", {**drag, "element": "nope"}),
                       ("/export", {"kind": "voxels"})]:
        with pytest.raises(urllib.error.HTTPError) as err:
            http(base + path, body)
        assert err.value.code == 400, path


def test_http_export_both_kinds(served, tmp_path):
    from signerf_tpu_torch.export import read_ply_header
    from signerf_tpu_torch.geometry.obj import load_obj

    base, _, _ = served
    pc = tmp_path / "pc.ply"
    out = json.loads(http(base + "/export", {"kind": "pointcloud", "path": str(pc), "downscale": 2,
                                             "min_accumulation": 0.0, "num_points": 200})[2])
    assert 0 < out["points"] <= 200 and read_ply_header(pc) == out["points"]
    mesh = tmp_path / "m.obj"
    out = json.loads(http(base + "/export", {"kind": "mesh", "path": str(mesh), "resolution": 16, "iso": "p50"})[2])
    verts, faces = load_obj(mesh)
    assert out["faces"] == len(faces) > 0 and out["vertices"] == len(verts)


def test_http_preview(served):
    base, iface, _ = served
    iface.set_reference_circle(radius=2.0, theta=60.0)
    iface.set_selection_aabb((5.0, 5.0, 5.0), (6.0, 6.0, 6.0))  # inverse_mask: every pixel edited
    sheets = json.loads(http(base + "/preview", {})[2])
    assert set(sheets) == {"image", "mask", "condition", "edited"}
    imgs = {k: decode_png(base64.b64decode(v)) for k, v in sheets.items()}
    h, w = imgs["image"].shape[:2]
    assert h % 8 == 0 and w % 8 == 0 and imgs["mask"].shape == (h, w, 1)
    assert imgs["mask"].mean() > 0 and not np.array_equal(imgs["edited"], imgs["image"])  # the fake edit


def test_http_generate_trains_the_edit_in(served):
    """POST /generate: generate, exchange, refine until `completed`; the
    edit lands in the NeRF. Runs last: it replaces the served pipeline."""
    base, iface, server = served
    trainer = iface.trainer
    iface.set_reference_circle(radius=2.0, theta=60.0)
    iface.set_selection_aabb((5.0, 5.0, 5.0), (6.0, 6.0, 6.0))  # the e2e test's box: every pixel edited
    view = 3  # the first generated view (3 references come first)
    box = (slice(EDIT_LO, EDIT_HI), slice(EDIT_LO, EDIT_HI))
    pre = []
    real_train = trainer.train

    def train():  # the exchanged NeRF's view, before the refinement
        pre.append(float(np.abs(render_view(trainer, view)[box] - EDIT_COLOR).mean()))
        real_train()

    trainer.train = train
    try:
        assert json.loads(http(base + "/generate", {})[2]) == {"started": True}
        assert json.loads(http(base + "/generate", {})[2]) == {"started": False, "reason": "busy"}
        deadline = time.time() + 300
        while trainer.training_state != "completed" and time.time() < deadline:
            time.sleep(0.2)
        server._worker.join(timeout=60)
    finally:
        trainer.train = real_train
    assert not server._worker.is_alive()
    assert trainer.training_state == "completed" and trainer.step >= trainer.config.max_num_iterations
    assert trainer.pipeline.datamanager.num_images == 3 + N_CAMS
    state = json.loads(http(base + "/state")[2])
    assert state["training_state"] == "completed" and "train_rays_per_sec" in state["metrics"]
    post = float(np.abs(render_view(trainer, view)[box] - EDIT_COLOR).mean())
    assert post < pre[0] - 0.05, f"the edit did not land: {pre[0]:.3f} -> {post:.3f}"
    assert decode_png(http(base + "/render?size=24")[2]).shape == (24, 24, 3)  # the new pipeline renders


# ---------------------------------------------------------------------------
# The train lock, the CLI, the writer
# ---------------------------------------------------------------------------


def test_viewer_renders_never_overlap_a_step_or_the_exchange(tmp_path, monkeypatch):
    """While /generate runs (generation, exchange, refinement), /render is
    hit in a loop: every optimizer step, every save and the exchange's
    rebuild run under the train lock, and so does every viewer render; no
    viewer render is in flight during a step."""
    from signerf_tpu_torch import pipeline as tpipeline

    held = {"step": [], "save": [], "build": [], "render": []}
    active = {"step": 0, "render": 0}
    overlaps = []
    worker = []  # the /generate thread, whose own renders (the generator's) take no lock

    def watched(kind, fn, sleep=0.0):
        def call(*args, **kw):
            held[kind].append(trainer.train_lock.locked())
            if kind in active:
                active[kind] += 1
                if active["render" if kind == "step" else "step"]:
                    overlaps.append(kind)
            try:
                time.sleep(sleep)  # widens the window an overlap would show in
                return fn(*args, **kw)
            finally:
                if kind in active:
                    active[kind] -= 1

        return call

    real_step = optimizers.GroupedAdam.step
    monkeypatch.setattr(optimizers.GroupedAdam, "step", lambda self: watched("step", real_step, 0.002)(self))
    real_make_eval_render = tpipeline.make_eval_render

    def make_eval_render(model, chunk_size):
        render = real_make_eval_render(model, chunk_size=chunk_size)
        viewer = watched("render", render, 0.002)
        return lambda *a, **kw: (render if threading.current_thread() in worker else viewer)(*a, **kw)

    monkeypatch.setattr(tpipeline, "make_eval_render", make_eval_render)
    trainer = port_trainer(write_tiny_dataset(tmp_path / "data"), tmp_path / "out")
    trainer.config.steps_per_call = 5
    trainer.config.max_num_iterations = 60
    trainer.save_checkpoint = watched("save", trainer.save_checkpoint)
    trainer._build_train_fn = watched("build", trainer._build_train_fn)
    iface = GenerationInterface(trainer)
    iface.set_reference_circle(radius=2.0, theta=60.0)
    server = ViewerServer(iface, port=0)
    httpd = server.start_background()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert json.loads(http(base + "/generate", {})[2]) == {"started": True}
        worker.append(server._worker)
        renders, deadline = 0, time.time() + 300
        while server._worker.is_alive() and time.time() < deadline:
            assert http(base + "/render?size=16")[0] == 200
            renders += 1
        server._worker.join(timeout=60)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert not server._worker.is_alive()
    assert trainer.training_state == "completed" and trainer.step == 60
    assert renders >= 5 and len(held["render"]) == renders and len(held["step"]) == 60
    assert held["build"] == [True] and len(held["save"]) >= 2
    for kind, flags in held.items():
        assert all(flags), f"{kind} ran without the train lock: {flags.count(False)} of {len(flags)}"
    assert overlaps == []


def test_train_lock_is_granted_in_order():
    """The train loop takes the lock again right after letting it go; a
    viewer already waiting gets it first."""
    from signerf_tpu_torch.engine.trainer import FairLock

    lock, order = FairLock(), []
    lock.acquire()

    def viewer():
        with lock:
            order.append("viewer")

    thread = threading.Thread(target=viewer)
    thread.start()
    deadline = time.time() + 10
    while lock._next < 2 and time.time() < deadline:  # the viewer has asked
        time.sleep(0.001)
    assert lock.locked()
    lock.release()
    with lock:
        order.append("train")
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert order == ["viewer", "train"] and not lock.locked()


def test_run_interface_serves_paused(monkeypatch):
    served = []
    monkeypatch.setattr(ViewerServer, "serve_forever", lambda self: served.append(self))

    class Trainer:
        training_state = "training"

    trainer = Trainer()
    app.run_interface(trainer)
    assert trainer.training_state == "paused"
    assert served[0].port == 7007 and served[0].interface.trainer is trainer


def test_writer_publishes_to_the_global_buffer(tmp_path, monkeypatch):
    monkeypatch.setattr(writer, "GLOBAL_BUFFER", {})
    w = writer.EventWriter(tmp_path / "log")
    w.write_scalars(7, {"total_loss": torch.tensor(0.25), "psnr": 21.5, "note": "skipped"})
    assert writer.GLOBAL_BUFFER == {"total_loss": 0.25, "psnr": 21.5}
    w.close()
    tracker = writer.RaysPerSecTracker()
    tracker.tick(1000)
    assert "train_rays_per_sec" not in writer.GLOBAL_BUFFER  # the first tick only starts the clock
    time.sleep(0.01)
    rate = tracker.tick(1000)
    assert rate > 0 and writer.GLOBAL_BUFFER["train_rays_per_sec"] == rate


def test_encode_png_is_save_array_pngs_file(tmp_path):
    rng = np.random.default_rng(0)
    for arr in (rng.random((5, 7, 3)), rng.random((6, 4)), rng.random((3, 3, 1)), np.full((2, 2, 3), np.nan)):
        save_array_png(arr, tmp_path / "a.png")
        data = encode_png(arr)
        assert data == (tmp_path / "a.png").read_bytes()
        want = (np.clip(np.nan_to_num(arr), 0, 1) * 255).astype(np.uint8).reshape(arr.shape[0], arr.shape[1], -1)
        np.testing.assert_array_equal(decode_png(data), want)


def test_interface_modules_import_no_jax():
    code = (
        "import sys, signerf_tpu_torch.interface, signerf_tpu_torch.interface.api, "
        "signerf_tpu_torch.interface.app, signerf_tpu_torch.interface.overlay, signerf_tpu_torch.train; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'signerf_tpu')); print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
