"""Both packages trained on chip_smoke.py's white scene at a reduced size,
from the same parameters on the same pixels: the loss, accumulation and
PSNR of each.

    JAX_PLATFORMS=cpu python -m tests.white_scene_parity [--steps 100] [--size 24]

The scene is chip_smoke.py's: 8 cameras on a ring of radius 2 around a
sphere of radius 0.6 shaded by |p| / 0.6, on a white backdrop, here at
size x size pixels. The model is tests/test_nerfacto_core.py's tiny config
with more samples a ray ((64, 32) proposal, 16 field) at the method's far
plane (1000) and background ("last_sample"), from the JAX package's seeded
init in both. Every step takes every pixel of every view (the same indices
in both packages, no jitter) through the train steps that
tests/test_torch_train.py::test_train_step_matches_jax drives; the port
takes its CPU route (the kernels' plain twins). Prints each package's loss
along the way, then the mean accumulation on the sphere's pixels and on
the backdrop's, and the PSNR of each package's render of the training
views. Not a tier-1 test: it takes minutes on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp
import chip_smoke as cs
from signerf_tpu.cameras.cameras import Cameras as JCameras
from signerf_tpu.engine import optimizers as jopt
from signerf_tpu.engine import train_step as jts
from signerf_tpu.models.nerfacto import NerfactoModel as JModel
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.engine import optimizers as topt
from signerf_tpu_torch.engine import train_step as tts
from signerf_tpu_torch.models.nerfacto import NerfactoModel
from tests.test_nerfacto_core import tiny_config
from tests.test_torch_train import DeterministicJaxModel, port_tiny_config

SAMPLES = dict(num_proposal_samples_per_ray=(64, 32), num_nerf_samples_per_ray=16)


def summary(rgb, acc, target, sphere) -> str:
    mse = float(np.mean((rgb - target) ** 2))
    return (f"accumulation on the sphere {acc[sphere].mean():.4f}, on the backdrop {acc[~sphere].mean():.4f}; "
            f"PSNR {-10 * np.log10(mse):.3f} dB")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--size", type=int, default=24)
    opts = parser.parse_args()
    torch.set_num_threads(2)
    cs.SCENE = {**cs.SCENE, "width": opts.size, "height": opts.size}
    poses, focal, views = cs.sphere_views(1.0)
    n_cams, s = len(views), opts.size
    target = np.stack(views)  # [cams, H, W, 3] in [0, 1]
    images = (target * 255 + 0.5).astype(np.uint8)
    target = images.astype(np.float32) / 255.0
    sphere = ~np.all(np.stack(views) == 1.0, axis=-1)
    c2w = poses[:, :3, :4].astype(np.float32)
    intr = dict(fx=np.full(n_cams, focal, np.float32), fy=np.full(n_cams, focal, np.float32),
                cx=np.full(n_cams, s / 2, np.float32), cy=np.full(n_cams, s / 2, np.float32))
    jcams = JCameras(camera_to_worlds=jnp.asarray(c2w), **{k: jnp.asarray(v) for k, v in intr.items()},
                     width=s, height=s)
    tcams = Cameras(camera_to_worlds=torch.from_numpy(c2w), **{k: torch.from_numpy(v) for k, v in intr.items()},
                    width=s, height=s)
    cam, yy, xx = np.meshgrid(np.arange(n_cams), np.arange(s), np.arange(s), indexing="ij")
    idx = np.stack([cam, yy, xx], -1).reshape(-1, 3).astype(np.int32)
    jts._sample_indices = lambda *a, **k: jnp.asarray(idx)
    tts._sample_indices = lambda *a, **k: torch.from_numpy(idx)
    print(f"scene {n_cams} views of {s}x{s} (sphere {sphere.mean():.1%} of the pixels), {len(idx)} rays a step, "
          f"{opts.steps} steps", flush=True)

    jcfg = dataclasses.replace(tiny_config(), **SAMPLES)
    jmodel = JModel(jcfg, num_train_images=n_cams)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    checkpoints = sorted({0, opts.steps // 4, opts.steps // 2, opts.steps - 1})

    t0 = time.perf_counter()
    jo = jopt.make_optimizer(jopt.OptimizersConfig(), params)
    jfn = jts.make_train_step(DeterministicJaxModel(jmodel), jo, jcams,
                              jts.SamplerSettings(num_rays=len(idx)), donate=False)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jo)
    jloss = {}
    for step in range(opts.steps):
        state, m = jfn(state, jnp.asarray(images), None, jax.random.PRNGKey(0))
        if step in checkpoints:
            jloss[step] = float(m["total_loss"])
    out = jmodel.apply(state.params, jcams.generate_rays_at(jnp.asarray(idx)), rng=None, train=False)
    jrgb = np.asarray(out["rgb"]).reshape(target.shape)
    jacc = np.asarray(out["accumulation"]).reshape(target.shape[:3])
    print(f"JAX  ({time.perf_counter() - t0:.0f} s): loss " + ", ".join(f"step {k} {v:.5f}" for k, v in jloss.items())
          + "; " + summary(jrgb, jacc, target, sphere), flush=True)

    t0 = time.perf_counter()
    model = NerfactoModel(dataclasses.replace(port_tiny_config(), **SAMPLES), n_cams)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    to = topt.make_optimizer(topt.OptimizersConfig(), model)
    tfn = tts.make_train_step(model, to, tcams, tts.SamplerSettings(num_rays=len(idx)))
    tloss = {}
    for step in range(opts.steps):
        m = tfn(step, torch.from_numpy(images), None, None)
        if step in checkpoints:
            tloss[step] = float(m["total_loss"])
    with torch.no_grad():
        out = model(tcams.generate_rays_at(torch.from_numpy(idx)), None, train=False)
    trgb = out["rgb"].numpy().reshape(target.shape)
    tacc = out["accumulation"].numpy().reshape(target.shape[:3])
    print(f"port ({time.perf_counter() - t0:.0f} s): loss " + ", ".join(f"step {k} {v:.5f}" for k, v in tloss.items())
          + "; " + summary(trgb, tacc, target, sphere), flush=True)
    print(f"the two renders: max |d rgb| {np.abs(trgb - jrgb).max():.4f}, max |d accumulation| "
          f"{np.abs(tacc - jacc).max():.4f}", flush=True)


if __name__ == "__main__":
    main()
