"""The port's training slice against the JAX package: the train step over
four optimizer steps (with a gated proposal step, micro-batches and camera
opt), the optimizer, the losses, rays at sampled pixels, camera opt, the
pixel samplers, checkpoints and their surgery, the PNG decoder, PSNR and
SSIM, and the train / render / eval CLIs.

Tiny model (tests/test_nerfacto_core.py's `tiny_config`), inputs made with
numpy from a seed and handed to both frameworks; sampling is deterministic
on both sides (fixed pixel indices, no jitter), since JAX threefry and torch
Philox draw different numbers.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from signerf_tpu.cameras import camera_opt as jco
from signerf_tpu.cameras.cameras import Cameras as JCameras
from signerf_tpu.data.datamanager import auto_micro_batches as jauto_micro
from signerf_tpu.engine import optimizers as jopt
from signerf_tpu.engine import train_step as jts
from signerf_tpu.models import losses as JL
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu.models.signerf import SIGNeRFModel as JSIGNeRFModel
from signerf_tpu.models.signerf import SIGNeRFModelConfig as JSIGNeRFModelConfig
from signerf_tpu.models.ray_samples import RaySamples as JRaySamples
from signerf_tpu.ops import image_metrics as jim
from signerf_tpu_torch.cameras import camera_opt as tco
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.convert import jax_params_from_state_dict, lpips_from_jax, state_dict_from_jax
from signerf_tpu_torch.data import datamanager as tdm
from signerf_tpu_torch.data import pixel_samplers as tps
from signerf_tpu_torch.engine import checkpoints as tck
from signerf_tpu_torch.engine import optimizers as topt
from signerf_tpu_torch.engine import train_step as tts
from signerf_tpu_torch.models import fields as tfields
from signerf_tpu_torch.models import losses as TL
from signerf_tpu_torch.models import nerfacto as tnerfacto
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig, ProposalNetArgs
from signerf_tpu_torch.models.ray_samples import RaySamples
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import image_metrics as tim
from signerf_tpu_torch.utils.images import decode_png, load_gray, load_rgb
from tests.test_nerfacto_core import tiny_config
from tests.test_pipeline_e2e import H as DH
from tests.test_pipeline_e2e import N_CAMS, write_tiny_dataset

torch.set_num_threads(2)

H = W = 16
NUM_RAYS = 32
NUM_CAMS = 2


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def port_tiny_config(**kw) -> NerfactoModelConfig:
    """tests/test_nerfacto_core.py's tiny_config in the port's knobs."""
    j = tiny_config()
    args = tuple(
        ProposalNetArgs(hidden_dim=a.hidden_dim, num_levels=a.num_levels, max_res=a.max_res)
        for a in j.proposal_net_args_list
    )
    return NerfactoModelConfig(
        max_res=j.max_res, hidden_dim=j.hidden_dim, hidden_dim_color=j.hidden_dim_color,
        appearance_embed_dim=j.appearance_embed_dim,
        num_proposal_samples_per_ray=j.num_proposal_samples_per_ray,
        num_nerf_samples_per_ray=j.num_nerf_samples_per_ray, proposal_net_args_list=args, **kw,
    )


def scene():
    """Two cameras looking down -z from z = 2 (tests/test_engine.py), smooth
    learnable images, and fixed pixel indices."""
    c2w = np.tile(np.eye(4, dtype=np.float32)[None, :3, :], (NUM_CAMS, 1, 1))
    c2w[:, 2, 3] = 2.0
    c2w[1, 0, 3] = 0.3
    intr = dict(fx=np.full(NUM_CAMS, 20.0, np.float32), fy=np.full(NUM_CAMS, 20.0, np.float32),
                cx=np.full(NUM_CAMS, W / 2, np.float32), cy=np.full(NUM_CAMS, H / 2, np.float32))
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grad_img = np.stack([xx / W, yy / H, np.full_like(xx, 0.5, dtype=np.float64)], -1)
    images = (np.stack([grad_img, 1.0 - grad_img]) * 255).astype(np.uint8)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, NUM_CAMS, NUM_RAYS), rng.integers(0, H, NUM_RAYS),
                    rng.integers(0, W, NUM_RAYS)], -1).astype(np.int32)
    jcams = JCameras(camera_to_worlds=jnp.asarray(c2w), **{k: jnp.asarray(v) for k, v in intr.items()},
                     width=W, height=H)
    tcams = Cameras(camera_to_worlds=torch.from_numpy(c2w), **{k: torch.from_numpy(v) for k, v in intr.items()},
                    width=W, height=H)
    return jcams, tcams, images, idx


class DeterministicJaxModel:
    """The JAX model with `rng=None` passed to `apply` (no jitter), so both
    packages sample the same bins. Nothing in the JAX package changes."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, bundle, rng=None, **kw):
        return self._model.apply(params, bundle, rng=None, **kw)


# Anneal reaches 1 at step 1 (the proposal grads are 0 at step 0, where
# w^0 = 1); with updates every 2 steps and no warmup, steps 1 and 3 are off
# the proposal schedule. A far plane of 6 keeps the samples near the scene.
GATE = dict(
    proposal_warmup=0, proposal_update_every=2, proposal_weights_anneal_max_num_iters=1, far_plane=6.0
)


def faint_proposals(params):
    """Low proposal densities, so that the proposal histograms fall under
    the field's and the interlevel loss (the proposals' only gradient) is
    not 0 from the start, as it is at this scene's init."""
    for i in range(2):
        bias = params[f"proposal_{i}"]["MLP_0"]["dense_1"]["bias"]
        params[f"proposal_{i}"]["MLP_0"]["dense_1"]["bias"] = np.asarray(bias) - 4.0


def run_both(monkeypatch, micro=1, camera_opt=False, steps=4):
    """Four steps of both train steps from the same params and indices.
    Returns (jax metrics, port metrics, jax params, port params, jax first
    grads, port first grads), params as the port's flat names."""
    jcfg = dataclasses.replace(tiny_config(), use_camera_opt=camera_opt, **GATE)
    jmodel = JModel(jcfg, num_train_images=NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    faint_proposals(params)
    if camera_opt:  # away from 0, where the SO3 norm has no derivative
        params["camera_opt"] = np.random.default_rng(1).normal(0, 0.02, (NUM_CAMS, 6)).astype(np.float32)
    jcams, tcams, images, idx = scene()
    settings = dict(num_rays=NUM_RAYS, micro_batches=micro)

    monkeypatch.setattr(jts, "_sample_indices", lambda *a, **k: jnp.asarray(idx))
    jproxy = DeterministicJaxModel(jmodel)
    jo = jopt.make_optimizer(jopt.OptimizersConfig(), params)
    jfn = jts.make_train_step(jproxy, jo, jcams, jts.SamplerSettings(**settings), donate=False)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jo)
    jmetrics = []
    for _ in range(steps):
        state, m = jfn(state, jnp.asarray(images), None, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    # first-step grads of the same loss (make_train_step does not return them)
    def loss(p):
        rb = jcams.generate_rays_at(jnp.asarray(idx))
        out = jmodel.apply(p, rb, rng=None, train=True, anneal=jmodel.anneal(0))
        target = jnp.asarray(images)[idx[:, 0], idx[:, 1], idx[:, 2]].astype(jnp.float32) / 255.0
        return sum(jax.tree_util.tree_leaves(jmodel.loss_dict(out, {"image": target})))

    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))

    # The port, with its density on the XLA contract (`density_mlp_reference`
    # under autograd) for like-for-like bf16 rounding with JAX on the CPU.
    monkeypatch.setattr(tfields, "fused_density_mlp", tfg.density_mlp_reference)
    monkeypatch.setattr(tts, "_sample_indices", lambda *a, **k: torch.from_numpy(idx))
    model = NerfactoModel(port_tiny_config(use_camera_opt=camera_opt, **GATE), NUM_CAMS)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    to = topt.make_optimizer(topt.OptimizersConfig(), model)
    tfn = tts.make_train_step(model, to, tcams, tts.SamplerSettings(**settings))
    tmetrics, tgrads = [], None
    for step in range(steps):
        m = tfn(step, torch.from_numpy(images), None, None)
        tmetrics.append({k: float(v) for k, v in m.items()})
        if step == 0:
            tgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    jparams = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    return jmetrics, tmetrics, jparams, model.state_dict(), jgrads, tgrads, state_dict_from_jax(params)


@pytest.mark.parametrize(
    "micro,camera_opt", [(1, False), (2, False), (1, True)], ids=["plain", "micro2", "camera_opt"]
)
def test_train_step_matches_jax(monkeypatch, micro, camera_opt):
    jm, tm, jp, tp, jg, tg, p0 = run_both(monkeypatch, micro, camera_opt)
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)
        for k in a:
            # Same f32 math up to summation order and bf16 one-ulp flips:
            # measured under 7e-4 relative.
            np.testing.assert_allclose(b[k], a[k], rtol=1e-2, atol=1e-6, err_msg=k)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        # Autograd through the same bf16 roundings, taken in another order:
        # per-leaf norm-relative, measured under 0.012.
        assert rel(tg[k], jg[k]) < 0.05, (k, rel(tg[k], jg[k]))
    for k in jp:
        # After 4 Adam steps with eps = 1e-15, an element whose gradient is
        # ~0 moves by +-lr on rounding noise alone, so compare per leaf by
        # norm-relative error: tables and kernels measured under 0.017; the
        # biases start at 0, so one flipped step in a 16-entry bias costs
        # about 0.04 (measured 0.042)...
        assert rel(tp[k], jp[k]) < 0.1, (k, rel(tp[k], jp[k]))
    # ...and the whole update taken, over all leaves: a flipped sign in a
    # sparse leaf costs that leaf, not the model (measured 0.084 to 0.097;
    # an update of +-lr per element makes this the strictest comparison).
    upd_t = torch.cat([(tp[k] - p0[k]).flatten() for k in jp])
    upd_j = torch.cat([(jp[k] - p0[k]).flatten() for k in jp])
    assert rel(upd_t, upd_j) < 0.2, rel(upd_t, upd_j)
    # the proposal networks learn (steps 2 and 3 move them, step 3 on
    # Adam's momentum alone; see the next test)
    moved = [float((tp[k] - p0[k]).abs().max()) for k in tp if k.startswith("proposal")]
    assert min(moved) > 0


def test_gated_step_zeroes_proposal_grads_but_steps_adam(monkeypatch):
    jcams, tcams, images, idx = scene()
    monkeypatch.setattr(tts, "_sample_indices", lambda *a, **k: torch.from_numpy(idx))
    model = NerfactoModel(port_tiny_config(**GATE), NUM_CAMS)
    params = jax_params_from_state_dict(
        model.reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    )
    faint_proposals(params)
    model.load_state_dict(state_dict_from_jax(params))
    opt = topt.make_optimizer(topt.OptimizersConfig(), model)
    fn = tts.make_train_step(model, opt, tcams, tts.SamplerSettings(num_rays=NUM_RAYS))
    for step in range(3):
        fn(step, torch.from_numpy(images), None, None)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    fn(3, torch.from_numpy(images), None, None)
    for n, p in model.named_parameters():
        if n.startswith("proposal"):
            assert float(p.grad.abs().max()) == 0.0, n
            # Adam with m != 0: the update is lr * m_hat / (sqrt(v_hat) + eps)
            assert not torch.equal(p.detach(), before[n]), n
    assert opt.state["proposal_networks"]["count"] == 4


# ---------------------------------------------------------------------------
# the signerf method: normals, LPIPS, patches
# ---------------------------------------------------------------------------

PATCH = 16  # one patch is a whole 16x16 image of the scene
SIGNERF_STEPS = 3


def signerf_configs(fast: bool):
    """The tiny config with the `signerf` method's losses, in both packages."""
    knobs = dict(predict_normals=True, use_lpips=True, use_l1=True, patch_size=PATCH,
                 fast_normals_losses=fast, **GATE)
    j, t = tiny_config(), port_tiny_config()
    jcfg = JSIGNeRFModelConfig(**{**{f.name: getattr(j, f.name) for f in dataclasses.fields(j)}, **knobs})
    tcfg = SIGNeRFModelConfig(**{**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)}, **knobs})
    return jcfg, tcfg


def run_signerf_both(monkeypatch, fast: bool):
    """SIGNERF_STEPS steps of both train steps (2 micro-batches of one whole
    patch each) and the first step's loss terms and gradients, from the same
    params, LPIPS weights and pixels. The port's base field takes the XLA
    route of `factor_density_geo_and_grad` (and its proposals the XLA
    density), as JAX does on the CPU."""
    jcfg, tcfg = signerf_configs(fast)
    jmodel = JSIGNeRFModel(jcfg, num_train_images=NUM_CAMS)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    faint_proposals(params)
    jcams, tcams, images, _ = scene()
    yy, xx = np.meshgrid(np.arange(PATCH), np.arange(PATCH), indexing="ij")
    idx = np.concatenate([np.stack([np.full_like(yy, c), yy, xx], -1).reshape(-1, 3) for c in range(NUM_CAMS)])
    idx = idx.astype(np.int32)
    settings = dict(num_rays=len(idx), patch_size=PATCH, micro_batches=2)
    target = images[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.float32) / 255.0

    monkeypatch.setattr(jts, "_sample_indices", lambda *a, **k: jnp.asarray(idx))
    jo = jopt.make_optimizer(jopt.OptimizersConfig(), params)
    jfn = jts.make_train_step(DeterministicJaxModel(jmodel), jo, jcams, jts.SamplerSettings(**settings),
                              donate=False)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jo)
    jmetrics = []
    for _ in range(SIGNERF_STEPS):
        state, m = jfn(state, jnp.asarray(images), None, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    def loss_terms(p):
        out = jmodel.apply(p, jcams.generate_rays_at(jnp.asarray(idx)), rng=None, train=True, anneal=jmodel.anneal(0))
        return jmodel.loss_dict(out, {"image": jnp.asarray(target)})

    jterms = {k: float(v) for k, v in jax.jit(loss_terms)(params).items()}
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(lambda p: sum(jax.tree_util.tree_leaves(loss_terms(p)))))(params)))

    monkeypatch.setattr(tfields, "fused_density_mlp", tfg.density_mlp_reference)
    monkeypatch.setattr(tnerfacto, "factor_density_geo_and_grad",
                        functools.partial(tfields.factor_density_geo_and_grad, xla=True))
    monkeypatch.setattr(tts, "_sample_indices", lambda *a, **k: torch.from_numpy(idx))
    model = SIGNeRFModel(tcfg, NUM_CAMS)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.lpips_params = lpips_from_jax(jmodel.lpips_params)
    out = model(tcams.generate_rays_at(torch.from_numpy(idx)), None, train=True, anneal=model.anneal(0))
    tterms = model.loss_dict(out, {"image": torch.from_numpy(target)})
    names, ps = zip(*model.named_parameters())
    tgrads = dict(zip(names, torch.autograd.grad(sum(tterms.values()), ps, allow_unused=True)))
    tterms = {k: float(v) for k, v in tterms.items()}
    to = topt.make_optimizer(topt.OptimizersConfig(), model)
    tfn = tts.make_train_step(model, to, tcams, tts.SamplerSettings(**settings))
    tmetrics = [{k: float(v) for k, v in tfn(step, torch.from_numpy(images), None, None).items()}
                for step in range(SIGNERF_STEPS)]
    return jterms, tterms, jgrads, tgrads, jmetrics, tmetrics


@pytest.mark.parametrize("fast", [False, True], ids=["reference_normals", "fast_normals_losses"])
def test_signerf_train_step_matches_jax(monkeypatch, fast):
    """All six loss terms, the first-step gradients per leaf and three train
    steps, against the JAX package's `signerf` model on the same params,
    LPIPS weights and pixels. With `fast_normals_losses` the gradient
    normals are detached at creation in both packages and the orientation
    loss takes the pred normals."""
    jterms, tterms, jgrads, tgrads, jm, tm = run_signerf_both(monkeypatch, fast)
    assert sorted(tterms) == sorted(jterms) == [
        "distortion_loss", "interlevel_loss", "lpips_loss", "orientation_loss", "pred_normal_loss", "rgb_loss"]
    for k in jterms:
        # the same expressions and bf16 roundings, f32 sums in another
        # order: measured up to 1.3e-5 relative (the orientation loss)
        np.testing.assert_allclose(tterms[k], jterms[k], rtol=1e-4, atol=1e-12, err_msg=k)
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        assert tgrads[k] is not None, k
        # per-leaf norm-relative, as the nerfacto step test: measured up to
        # 0.016 (the pred-normal head's biases)
        assert rel(tgrads[k], jgrads[k]) < 0.05, (k, rel(tgrads[k], jgrads[k]))
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)
        for k in a:
            # Measured up to 3.1e-4 relative, except the orientation loss:
            # after an Adam step with eps = 1e-15 an element whose gradient
            # is rounding noise moves by +-lr, and this 1e-5 penalty, fed
            # only by normals that face away from the camera, moved by up
            # to 0.024 (step 1 of the fast variant).
            rtol = 0.05 if k == "orientation_loss" else 1e-2
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-12, err_msg=k)


def test_signerf_orientation_loss_trains_the_line_tables():
    """Reference semantics: the orientation loss alone reaches the line
    tables through the undetached gradient normals (K5 and K6's twins here)
    and leaves the pred-normal head alone. Under `fast_normals_losses` the
    gradient normals are detached at creation and the orientation loss
    trains the pred-normal head instead."""
    jcams, tcams, images, idx = scene()
    for fast in (False, True):
        _, tcfg = signerf_configs(fast)
        model = SIGNeRFModel(tcfg, NUM_CAMS).reset_parameters(torch.Generator().manual_seed(0))
        out = model(tcams.generate_rays_at(torch.from_numpy(idx)), None, train=True, anneal=1.0)
        assert out["normals_samples"].requires_grad is not fast
        model.normals_losses(out)["orientation_loss"].backward()
        line = model.field.encoding.line_3_0.grad
        head = model.field.mlp_pred_normals.dense_2.kernel.grad
        assert bool(torch.isfinite(line).all()) and float(line.abs().max()) > 0
        assert (head is not None and float(head.abs().max()) > 0) is fast


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _tree(seed=11):
    rng = np.random.default_rng(seed)
    return {
        "field": {
            "lines": {f"l{i}": rng.standard_normal((17 + 3 * i, 16)).astype(np.float32) for i in range(3)},
            "appearance": {"embedding": rng.standard_normal((5, 8)).astype(np.float32)},
            "mlp": {"w": rng.standard_normal((16, 8)).astype(np.float32)},
        },
        "proposal_0": {"w": rng.standard_normal((9, 4)).astype(np.float32)},
        "proposal_1": {"w": rng.standard_normal((7, 4)).astype(np.float32)},
        "camera_opt": {"pose": (rng.standard_normal((5, 6)) * 0.01).astype(np.float32)},
    }


@pytest.mark.parametrize("fused", [True, False])
def test_optimizer_matches_jax(fused):
    """Four updates against `make_optimizer` with the fused flat-group
    update on and off (optax multi_transform), as tests/test_engine.py
    compares those two."""
    params = _tree()
    cfg = jopt.OptimizersConfig(
        fused_update=fused,
        fields=jopt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=3),
        proposal_networks=jopt.OptimizerGroupConfig(lr=5e-3, lr_final=1e-3, max_steps=2, warmup_steps=2),
    )
    jo = jopt.make_optimizer(cfg, params)
    jstate = jo.init(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    sd = state_dict_from_jax(params)
    tparams = {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()}
    to = topt.GroupedAdam(
        topt.OptimizersConfig(
            fields=topt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=3),
            proposal_networks=topt.OptimizerGroupConfig(lr=5e-3, lr_final=1e-3, max_steps=2, warmup_steps=2),
        ),
        tparams.items(),
    )
    assert sorted(to.names) == ["appearance", "camera_opt", "fields", "proposal_networks"]
    rng = np.random.default_rng(0)
    for _ in range(4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in sd.items()}
        grads["field.lines.l0"][:3] = 0.0  # untouched rows stay put
        u, jstate = jo.update(jax_params_from_state_dict({k: torch.from_numpy(g) for k, g in grads.items()}),
                              jstate, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        to.step()
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
        for k, p in tparams.items():
            # The same f32 formulas; one-ulp differences of m and v: 1e-6.
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_schedule_matches_optax():
    cases = [
        jopt.OptimizerGroupConfig(),
        jopt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=10),  # floor at lr_final
        jopt.OptimizerGroupConfig(lr=1e-15, lr_final=None),
        jopt.OptimizerGroupConfig(lr=1e-3, lr_final=1e-5, max_steps=50, warmup_steps=7),
    ]
    for c in cases:
        js = jopt.make_schedule(c)
        ts = topt.make_schedule(topt.OptimizerGroupConfig(**dataclasses.asdict(c)))
        for count in [0, 1, 6, 7, 8, 9, 10, 25, 60, 200_000, 400_000]:
            # optax evaluates in f32, the port in f64: 1e-6 relative
            np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6, atol=1e-20)


def test_appearance_decay_is_adamw():
    """The appearance group's decay is decoupled: it equals torch.optim.AdamW
    with the fields' schedule (constant here)."""
    rng = np.random.default_rng(2)
    start = rng.standard_normal((6, 4)).astype(np.float32)
    a = torch.nn.Parameter(torch.from_numpy(start.copy()))
    b = torch.nn.Parameter(torch.from_numpy(start.copy()))
    cfg = topt.OptimizersConfig(fields=topt.OptimizerGroupConfig(lr=1e-2, lr_final=None))
    ours = topt.GroupedAdam(cfg, [("field.appearance.embedding", a)])
    ref = torch.optim.AdamW([b], lr=1e-2, eps=1e-15, weight_decay=0.1 / 1e-2 * 1e-2)
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
        a.grad, b.grad = g.clone(), g.clone()
        ours.step()
        ref.step()
        # AdamW: p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p); one-ulp
        # differences from the order of operations
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_optimizer_groups_and_state_round_trip(tmp_path):
    model = NerfactoModel(port_tiny_config(use_camera_opt=True), NUM_CAMS)
    opt = topt.make_optimizer(topt.OptimizersConfig(), model)
    assert opt.names["appearance"] == ["field.appearance.embedding"]
    assert opt.names["camera_opt"] == ["camera_opt"]
    assert all(n.startswith("proposal") for n in opt.names["proposal_networks"])
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = tck.save_checkpoint(tmp_path, 3, model.state_dict(), opt)
    loaded = tck.load_checkpoint(path)
    assert loaded["step"] == 3 and path.name == "step-000000003.pt"
    other = topt.make_optimizer(topt.OptimizersConfig(), model)
    other.load_state_dict(loaded["optimizer"])
    assert other.state["fields"]["count"] == 1
    for g in opt.state:
        for a, b in zip(opt.state[g]["m"], other.state[g]["m"]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# small modules
# ---------------------------------------------------------------------------


def _samples(rng, r, s):
    bins = np.sort(rng.random((r, s + 1)), axis=-1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    o = np.zeros((r, 3), np.float32)
    d = np.ones((r, 3), np.float32)
    j = JRaySamples(origins=o, directions=d, starts=bins[:, :-1], ends=bins[:, 1:],
                    spacing_starts=bins[:, :-1], spacing_ends=bins[:, 1:])
    t = RaySamples(origins=torch.from_numpy(o), directions=torch.from_numpy(d),
                   starts=torch.from_numpy(bins[:, :-1]), ends=torch.from_numpy(bins[:, 1:]),
                   spacing_starts=torch.from_numpy(bins[:, :-1]), spacing_ends=torch.from_numpy(bins[:, 1:]))
    return j, t


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    r = 9
    jf, tf = _samples(rng, r, 7)
    jp0, tp0 = _samples(rng, r, 12)
    jp1, tp1 = _samples(rng, r, 10)
    w = rng.random((r, 7)).astype(np.float32) * 0.3
    wp0 = rng.random((r, 12)).astype(np.float32) * 0.2
    wp0[:, 3] = 0.0  # a flat cumulative sum: tied maxima
    wp1 = rng.random((r, 10)).astype(np.float32) * 0.2

    def jloss(w_, a, b):
        return (JL.interlevel_loss([a, b], [jp0, jp1], w_, jf), JL.distortion_loss(w_, jf))

    (ji, jd) = jloss(w, wp0, wp1)
    jgi = jax.grad(lambda a, b: jloss(w, a, b)[0], argnums=(0, 1))(wp0, wp1)
    jgd = jax.grad(lambda w_: jloss(w_, wp0, wp1)[1])(w)
    tw, ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (w, wp0, wp1))
    ti = TL.interlevel_loss([ta, tb], [tp0, tp1], tw, tf)
    td = TL.distortion_loss(tw, tf)
    ti.backward()
    assert tw.grad is None  # the final weights are detached in the interlevel loss
    td.backward()
    # f32 reductions in another order: 1e-5 relative on values and grads
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgi[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgi[1]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgd), rtol=1e-5, atol=1e-7)

    pred = rng.random((r, 3)).astype(np.float32)
    target = rng.random((r, 3)).astype(np.float32)
    for jfn, tfn in [(JL.mse_loss, TL.mse_loss), (JL.l1_loss, TL.l1_loss), (JL.psnr, TL.psnr)]:
        jv, jg = jax.value_and_grad(jfn)(pred, target)
        tp = torch.from_numpy(pred).requires_grad_(True)
        tv = tfn(tp, torch.from_numpy(target))
        tv.backward()
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)


def test_anneal_matches_jax():
    jm = JModel(tiny_config(), num_train_images=2)
    tm = NerfactoModel(port_tiny_config(), 2)
    for step in [0, 1, 10, 99, 500, 999, 1000, 5000]:
        np.testing.assert_allclose(tm.anneal(step), float(jm.anneal(step)), rtol=1e-6)  # both f32


def test_generate_rays_at_matches_jax():
    jcams, tcams, _, idx = scene()
    dist = np.random.default_rng(4).normal(0, 0.01, (NUM_CAMS, 6)).astype(np.float32)
    jcams = dataclasses.replace(jcams, distortion_params=jnp.asarray(dist))
    tcams = dataclasses.replace(tcams, distortion_params=torch.from_numpy(dist))
    jb = jcams.generate_rays_at(jnp.asarray(idx))
    tb = tcams.generate_rays_at(torch.from_numpy(idx))
    assert tb.nears is None and tb.fars is None  # no aabb: the model's planes
    for k in ("origins", "directions", "pixel_area"):
        # the same f32 ops (10 Newton steps); 1e-5 relative
        np.testing.assert_allclose(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tb.camera_indices.numpy(), np.asarray(jb.camera_indices))


def test_camera_opt_matches_jax():
    rng = np.random.default_rng(5)
    tangent = (rng.standard_normal((4, 6)) * 0.1).astype(np.float32)
    tangent[0] = 0.0  # the small-angle fallback
    np.testing.assert_allclose(
        tco.exp_map_so3xr3(torch.from_numpy(tangent)).numpy(),
        np.asarray(jco.exp_map_so3xr3(jnp.asarray(tangent))), rtol=1e-5, atol=1e-7,
    )
    o = rng.standard_normal((10, 3)).astype(np.float32)
    d = rng.standard_normal((10, 3)).astype(np.float32)
    ci = rng.integers(0, 4, 10).astype(np.int32)
    jo, jd = jco.apply_camera_opt(jnp.asarray(tangent), o, d, jnp.asarray(ci))
    to_, td = tco.apply_camera_opt(torch.from_numpy(tangent), torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(ci))
    np.testing.assert_allclose(to_.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    assert torch.equal(tco.init_camera_opt(3), torch.zeros(3, 6))


def test_pixel_samplers_shapes_ranges_and_patch_layout():
    g = torch.Generator().manual_seed(0)
    idx = tps.sample_pixels(g, 500, 3, 7, 11)
    assert idx.shape == (500, 3) and idx.dtype == torch.int32
    for col, hi in enumerate((3, 7, 11)):
        assert int(idx[:, col].min()) >= 0 and int(idx[:, col].max()) < hi
    mask = torch.tensor([[0, 1, 2], [1, 0, 0], [2, 5, 5]], dtype=torch.int32)
    picked = tps.sample_pixels_masked(g, 50, mask)
    assert all(any(torch.equal(row, m) for m in mask) for row in picked)
    patches = tps.sample_patches(g, 70, 4, 3, 9, 10)
    assert patches.shape == (64, 3)  # floor(70 / 16) patches of 4 x 4
    p = patches.view(4, 4, 4, 3).long()
    assert bool((p[..., 0] == p[:, :1, :1, 0]).all())  # one camera per patch
    assert torch.equal(p[:, :, 0, 1] - p[:, :1, :1, 1].squeeze(-1), torch.arange(4).expand(4, 4))
    assert torch.equal(p[:, 0, :, 2] - p[:, :1, :1, 2].squeeze(-1), torch.arange(4).expand(4, 4))
    assert int(p[..., 1].max()) < 9 and int(p[..., 2].max()) < 10
    images = torch.arange(3 * 9 * 10 * 3, dtype=torch.int32).view(3, 9, 10, 3)
    got = tps.gather_pixels(images, patches)
    pl = patches.long()
    assert torch.equal(got, images[pl[:, 0], pl[:, 1], pl[:, 2]])


def test_auto_micro_batches_matches_jax():
    for n, ps, mask in [(4096, 1, False), (16384, 32, False), (16384, 32, True), (12289, 1, False),
                        (8192, 1, False), (4097, 1, False)]:
        assert tdm.auto_micro_batches(n, ps, mask) == jauto_micro(n, ps, mask)


def test_checkpoint_surgery_and_drop_proposals(tmp_path):
    model = NerfactoModel(port_tiny_config(use_camera_opt=True), NUM_CAMS)
    model.reset_parameters(torch.Generator().manual_seed(1))
    saved = {k: v + 1.0 for k, v in model.state_dict().items()}
    path = tck.save_checkpoint(tmp_path, 12, saved)
    assert tck.latest_checkpoint(tmp_path) == path
    assert tck.latest_checkpoint(tmp_path / "missing") is None
    init = model.state_dict()
    stripped = tck.strip_appearance_and_camera_opt(saved)
    assert "camera_opt" not in stripped and "field.appearance.embedding" not in stripped
    assert all(not k.startswith("proposal") for k in tck.strip_proposals(saved))
    for drop in (False, True):
        got = tck.surgical_restore(path, init, drop_proposals=drop)
        assert sorted(got) == sorted(init)
        for k in got:
            fresh = k in ("camera_opt", "field.appearance.embedding") or (drop and k.startswith("proposal"))
            assert torch.equal(got[k], init[k] if fresh else saved[k]), (k, drop)


def test_png_decoder_matches_pillow(tmp_path):
    """The stdlib decoder against Pillow on the fixture dataset's images
    (Pillow's encoder picks all five row filters) and on gray, gray+alpha
    and RGBA images."""
    from PIL import Image

    data = write_tiny_dataset(tmp_path / "data")
    files = sorted((data / "images").glob("*.png"))
    for f in files:
        np.testing.assert_array_equal(load_rgb(f), np.asarray(Image.open(f).convert("RGB")))
        np.testing.assert_array_equal(load_gray(f), np.asarray(Image.open(f).convert("L")))
    rng = np.random.default_rng(6)
    for mode, shape in [("L", (13, 21)), ("LA", (9, 8, 2)), ("RGBA", (12, 7, 4)), ("RGB", (40, 33, 3))]:
        smooth = np.linspace(0, 200, int(np.prod(shape))).reshape(shape)
        a = (smooth + rng.integers(0, 50, shape)).astype(np.uint8)
        for level in (0, 6, 9):
            Image.fromarray(a, mode).save(tmp_path / "x.png", compress_level=level, optimize=level == 9)
            got = decode_png((tmp_path / "x.png").read_bytes())
            np.testing.assert_array_equal(got.reshape(a.shape), a)
            np.testing.assert_array_equal(load_rgb(tmp_path / "x.png"),
                                          np.asarray(Image.open(tmp_path / "x.png").convert("RGB")))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def test_datamanager_holds_uint8_images_and_refuses_other_sizes(tmp_path):
    data = write_tiny_dataset(tmp_path / "data")
    cfg = tdm.SIGNeRFDataManagerConfig(dataparser=tdm.SIGNeRFDataParserConfig(data=data))
    dm = tdm.SIGNeRFDataManager(cfg, torch.device("cpu"))
    assert dm.images.dtype == torch.uint8 and dm.images.shape == (N_CAMS, DH, DH, 3)
    assert dm.num_images == N_CAMS and dm.sampler_settings().micro_batches == 1
    from PIL import Image

    # An image of another size than its camera's is resized to it, as the
    # JAX loader does (its native codec's bilinear rule), not refused.
    odd = data / "images" / "frame_00002.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (DH + 2, DH, 3), np.uint8)).save(odd)
    from signerf_tpu.data.datamanager import load_images as jload_images

    dm = tdm.SIGNeRFDataManager(cfg, torch.device("cpu"))
    assert dm.images.shape == (N_CAMS, DH, DH, 3)
    np.testing.assert_array_equal(dm.images[2].numpy(), jload_images([odd], DH, DH)[0])


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 26), indexing="ij")
    a = np.stack([xx, yy, xx * yy], -1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tim.psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jim.psnr(a, b)), rtol=1e-5)
    # f32 blur as matmuls here, as convolutions there: 1e-5 relative
    np.testing.assert_allclose(float(tim.ssim(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jim.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

SMALL_MODEL = [
    "--max-res", "32", "--hidden-dim", "8", "--hidden-dim-color", "8",
    "--num-proposal-samples-per-ray", "[8, 6]", "--num-nerf-samples-per-ray", "4",
]


def _model_flags(prefix):
    return [f"--{prefix}{a[2:]}" if a.startswith("--") else a for a in SMALL_MODEL]


def test_train_cli_then_render_and_eval(tmp_path):
    from signerf_tpu_torch import eval as eval_cli
    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch import train as train_cli

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    rc = train_cli.main(
        ["signerf_nerfacto", "--data", str(data), "--train-only", "True", "--device", "cpu",
         "--max-num-iterations", "6", "--steps-per-call", "2", "--steps-per-save", "4",
         "--output-dir", str(out), "--pipeline.datamanager.train-num-rays-per-batch", "64",
         *_model_flags("pipeline.model.")]
    )
    assert rc == 0
    ckpt_dir = out / "experiment" / "signerf_nerfacto" / "checkpoints"
    names = sorted(p.name for p in ckpt_dir.glob("step-*.pt"))
    assert names == ["step-000000004.pt", "step-000000006.pt"]
    ckpt = tck.load_checkpoint(ckpt_dir / names[-1])
    assert ckpt["step"] == 6 and ckpt["optimizer"]["groups"]["fields"]["count"] == 6
    assert (out / "experiment" / "signerf_nerfacto" / "events.jsonl").exists()
    assert render_cli.main(["--data", str(data), "--output", str(tmp_path / "r"), "--load-dir",
                            str(ckpt_dir), "--device", "cpu", "--depth", "false",
                            *_model_flags("model.")]) == 0
    assert len(list((tmp_path / "r").glob("rgb_*.png"))) == N_CAMS
    assert eval_cli.main(["--data", str(data), "--output", str(tmp_path / "e.json"), "--load-dir",
                          str(ckpt_dir), "--device", "cpu", *_model_flags("model.")]) == 0
    import json

    summary = json.loads((tmp_path / "e.json").read_text())
    assert summary["num_images"] == N_CAMS and np.isfinite(summary["psnr"]) and 0 < summary["ssim"] <= 1


def test_signerf_train_cli_then_eval_with_lpips(tmp_path):
    """`signerf --train-only True --device cpu` at a tiny size (16x16
    patches, normals, random LPIPS with its warning), then the eval CLI
    with `--lpips true`, which warns too and reports a finite LPIPS."""
    import json

    from signerf_tpu_torch import eval as eval_cli
    from signerf_tpu_torch import train as train_cli

    data = write_tiny_dataset(tmp_path / "data")
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        rc = train_cli.main(
            ["signerf", "--data", str(data), "--train-only", "True", "--device", "cpu",
             "--max-num-iterations", "4", "--steps-per-call", "2", "--steps-per-save", "4",
             "--output-dir", str(out), "--pipeline.datamanager.train-num-rays-per-batch", "512",
             "--pipeline.datamanager.patch-size", "16", "--pipeline.model.patch-size", "16",
             *_model_flags("pipeline.model.")]
        )
    assert rc == 0
    ckpt_dir = out / "experiment" / "signerf" / "checkpoints"
    ckpt = tck.load_checkpoint(ckpt_dir / "step-000000004.pt")
    assert any(k.startswith("field.mlp_pred_normals.") for k in ckpt["params"])
    assert not any("lpips" in k for k in ckpt["params"])
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        assert eval_cli.main(["--data", str(data), "--output", str(tmp_path / "e.json"), "--load-dir",
                              str(ckpt_dir), "--device", "cpu", "--lpips", "true",
                              "--model.predict-normals", "True", *_model_flags("model.")]) == 0
    summary = json.loads((tmp_path / "e.json").read_text())
    assert np.isfinite(summary["lpips"]) and len(summary["per_image"]) == N_CAMS
    assert all(np.isfinite(r["lpips"]) and r["lpips"] >= 0 for r in summary["per_image"])


def test_signerf_method_hyperparameters():
    from signerf_tpu.method_configs import signerf_method as jmethod
    from signerf_tpu_torch.method_configs import signerf_method

    j, t = jmethod(), signerf_method()
    assert t.method_name == "signerf" and t.max_num_iterations == j.max_num_iterations == 20000
    dm = t.pipeline.datamanager
    assert (dm.train_num_rays_per_batch, dm.patch_size) == (16384, 32)
    assert tdm.auto_micro_batches(16384, 32, False) == 4
    m, jm = t.pipeline.model, j.pipeline.model
    for k in ("predict_normals", "use_lpips", "use_l1", "patch_size", "average_init_density", "lpips_net",
              "fast_normals_losses", "orientation_loss_mult", "pred_normal_loss_mult"):
        assert getattr(m, k) == getattr(jm, k), k
    for group in ("fields", "proposal_networks", "camera_opt"):
        a, b = getattr(t.optimizers, group), getattr(j.optimizers, group)
        assert (a.lr, a.eps, a.lr_final, a.max_steps) == (b.lr, b.eps, b.lr_final, b.max_steps), group


def test_train_cli_refusals(tmp_path, monkeypatch):
    from signerf_tpu_torch import train as train_cli

    data = write_tiny_dataset(tmp_path / "data")
    # With --skip-interface True (and without --train-only) the CLI runs the
    # headless edit flow, which needs the reference sheet's poses (a
    # previous experiment's transforms.json).
    base = ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--skip-interface", "True",
            *_model_flags("pipeline.model.")]
    with pytest.raises(ValueError, match="reference sheet's poses"):
        train_cli.main(list(base))
    with pytest.raises(ValueError, match="reference sheet's poses"):
        train_cli.main(["signerf", "--data", str(data), "--device", "cpu", "--skip-interface", "True",
                        *_model_flags("pipeline.model.")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["signerf_nerfacto", "--data", str(data), "--train-only", "True"])


def test_train_and_eval_cli_import_no_jax():
    """Also after building the `signerf` method's model (LPIPS, normals)."""
    code = (
        "import sys, signerf_tpu_torch.train, signerf_tpu_torch.eval; "
        "from signerf_tpu_torch.method_configs import signerf_method; "
        "from signerf_tpu_torch.models.signerf import SIGNeRFModel; "
        "SIGNeRFModel(signerf_method().pipeline.model, 2); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'signerf_tpu')); print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
