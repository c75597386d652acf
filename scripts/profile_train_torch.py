"""Attribute the train hot path of the PyTorch port on the card: the twin of
scripts/profile_train.py.

One optimizer step of `signerf_nerfacto`'s regime (4096 rays, the
full-size model, MSE) and its parts at the same shapes: the model's
forward with its losses, forward + backward, the optimizer update, each
field's forward and forward + backward at its train-step sample count, the
encode kernels (K3, K4) and the density MLP, the sampling machinery with
the interlevel and distortion losses, and pixel sampling with ray
generation. Then the `signerf` regime (16,384 rays as 32x32 patches in 4
micro-batches, L1 + LPIPS, normals): the step, the step without normals,
without LPIPS and with `fast_normals_losses`, LPIPS alone, patch sampling,
and the closed-form normals at one micro-batch. Both steps are also broken
down by kernel under `torch.profiler`. Each stage is the median of 5
windows of CUDA events after a warm-up, with its range. Usage, from the
repository root, on a card:

    python scripts/profile_train_torch.py [--json TRAIN_BREAKDOWN_TORCH.json] [--signerf]

`--signerf` runs the `signerf` regime alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.cameras.cameras import Cameras, RayBundle  # noqa: E402
from signerf_tpu_torch.data.datamanager import auto_micro_batches  # noqa: E402
from signerf_tpu_torch.data.pixel_samplers import gather_pixels, sample_patches, sample_pixels  # noqa: E402
from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer  # noqa: E402
from signerf_tpu_torch.engine.train_step import SamplerSettings, default_loss_fn, make_train_step  # noqa: E402
from signerf_tpu_torch.models import losses as L  # noqa: E402
from signerf_tpu_torch.models.fields import factor_density_geo_and_grad  # noqa: E402
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig  # noqa: E402
from signerf_tpu_torch.models.samplers import proposal_sample, render_weights  # noqa: E402
from signerf_tpu_torch.models.signerf import SIGNeRFModel, SIGNeRFModelConfig  # noqa: E402
from signerf_tpu_torch.ops.factor_grid import FactorGridConfig, encode_fused, mlp2_reference  # noqa: E402
from signerf_tpu_torch.ops.lpips import lpips  # noqa: E402
from signerf_tpu_torch.utils.microbench import (  # noqa: E402
    TRAIN_KERNEL_GROUPS,
    Stages,
    kernel_breakdown,
    require_cuda,
    write_breakdown,
)

NUM_RAYS, SIGNERF_RAYS, PATCH = 4096, 16384, 32
H = W = 128
VIEWS = 8
GROUPS = [*TRAIN_KERNEL_GROUPS, ("GEMMs", ("gemm", "cutlass", "matmul")),
          ("optimizer and elementwise", ("elementwise", "vectorized", "unrolled", "foreach"))]


def cameras(dev) -> Cameras:
    c2w = torch.eye(4)[None, :3, :].repeat(VIEWS, 1, 1)
    c2w[:, 2, 3] = 3.0
    full = lambda v: torch.full((VIEWS,), float(v))  # noqa: E731
    return Cameras(camera_to_worlds=c2w, fx=full(160), fy=full(160), cx=full(W / 2), cy=full(H / 2), width=W,
                   height=H).to(dev)


def grads_sum(params) -> torch.Tensor:
    return sum(p.grad.sum() for p in params if p.grad is not None)


def breakdown(label: str, fn, out: dict, iters: int = 3) -> None:
    bd = kernel_breakdown(fn, GROUPS, iters=iters)
    out[label] = {"span_ms": round(bd["span_ms"], 4), "busy_ms": round(bd["busy_ms"], 4),
                  "idle_share": round(bd["idle_share"], 4),
                  "groups_ms": {k: round(v, 4) for k, v in bd["groups_ms"].items()}}
    print(f"  {label}: span {bd['span_ms']:.3f} ms, device busy {bd['busy_ms']:.3f} ms, idle {bd['idle_share']:.1%}; "
          + "; ".join(f"{k} {v:.3f}" for k, v in bd["groups_ms"].items()), flush=True)


def train_step_fn(model, cams, images, settings):
    step = make_train_step(model, make_optimizer(OptimizersConfig(), model), cams, settings)
    gen = torch.Generator(device=images.device).manual_seed(2)
    index = itertools.count()
    return lambda: step(next(index), images, None, gen)


def nerfacto_sections(stages: Stages, out: dict, cams, images, dev) -> None:
    cfg = NerfactoModelConfig()
    model = NerfactoModel(cfg, num_train_images=VIEWS).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    step = train_step_fn(model, cams, images, SamplerSettings(num_rays=NUM_RAYS))
    t = stages.time("train_step_total", step)
    out["train_rays_per_s"] = round(NUM_RAYS / t * 1e3, 1)
    breakdown("train_step_kernel_breakdown", step, out)

    gen = torch.Generator(device=dev).manual_seed(1)
    dirs = torch.randn(NUM_RAYS, 3, generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    bundle = RayBundle(origins=torch.zeros(NUM_RAYS, 3, device=dev), directions=dirs,
                       pixel_area=torch.full((NUM_RAYS, 1), 1e-6, device=dev),
                       camera_indices=torch.zeros(NUM_RAYS, 1, dtype=torch.int32, device=dev),
                       nears=torch.full((NUM_RAYS, 1), 0.05, device=dev),
                       fars=torch.full((NUM_RAYS, 1), 1000.0, device=dev))
    batch = {"image": torch.rand(NUM_RAYS, 3, generator=gen, device=dev)}

    def loss():
        return default_loss_fn(model, model(bundle, gen, train=True, anneal=1.0), batch)[0]

    with torch.no_grad():
        stages.time("model_fwd_plus_losses", loss)

    def fwd_bwd():
        model.zero_grad()
        loss().backward()

    stages.time("model_fwd_bwd", fwd_bwd)
    opt = make_optimizer(OptimizersConfig(), model)
    fwd_bwd()
    stages.time("optimizer_update", opt.step)

    n_final = NUM_RAYS * cfg.num_nerf_samples_per_ray
    pos = torch.rand(n_final, 3, generator=gen, device=dev) * 2 - 1
    field_params = list(model.field.parameters())
    with torch.no_grad():
        stages.time(f"final_field_density_fwd_N{n_final}", lambda: model.field.density(pos))

    def field_fb():
        model.field.zero_grad()
        d, geo = model.field.density(pos)
        (d.sum() + geo.float().sum() * 1e-3).backward()
        return grads_sum(field_params)

    stages.time(f"final_field_density_fwd_bwd_N{n_final}", field_fb)
    for i, ns in enumerate(cfg.num_proposal_samples_per_ray):
        prop = getattr(model, f"proposal_{i}")
        posp = torch.rand(NUM_RAYS * ns, 3, generator=gen, device=dev) * 2 - 1
        with torch.no_grad():
            stages.time(f"proposal{i}_fwd_N{posp.shape[0]}", lambda p=prop, q=posp: p(q))

        def prop_fb(p=prop, q=posp):
            p.zero_grad()
            p(q).sum().backward()

        stages.time(f"proposal{i}_fwd_bwd_N{posp.shape[0]}", prop_fb)

    enc_cfg = FactorGridConfig(num_levels=8, base_res=cfg.base_res, max_res=cfg.max_res, features_per_level=16)
    lines = tuple(tuple((torch.randn(res, 16, generator=gen, device=dev) * 0.2).requires_grad_(True)
                        for _ in range(3)) for res in enc_cfg.resolutions)
    flat = [t for axes in lines for t in axes]
    x01 = torch.rand(n_final, 3, generator=gen, device=dev)
    with torch.no_grad():
        stages.time(f"encode_kernel_fwd_N{n_final}", lambda: encode_fused(enc_cfg, lines, x01))

    def enc_fb():
        for t in flat:
            t.grad = None
        encode_fused(enc_cfg, lines, x01).sum().backward()

    stages.time(f"encode_kernel_fwd_bwd_N{n_final}", enc_fb)
    feats = torch.randn(n_final, enc_cfg.out_dim, generator=gen, device=dev)
    ws = [[(torch.randn(enc_cfg.out_dim, cfg.hidden_dim, generator=gen, device=dev) * 0.1).requires_grad_(True),
           torch.zeros(cfg.hidden_dim, device=dev, requires_grad=True)],
          [(torch.randn(cfg.hidden_dim, 16, generator=gen, device=dev) * 0.1).requires_grad_(True),
           torch.zeros(16, device=dev, requires_grad=True)]]

    def mlp_fb():
        for t in itertools.chain(*ws):
            t.grad = None
        mlp2_reference(feats, ws).float().sum().backward()

    stages.time(f"density_mlp_fwd_bwd_N{n_final}", mlp_fb)

    free = [lambda p: p.sum(-1) * 0 + 0.1] * 2
    with torch.no_grad():
        stages.time("sampling_machinery_fwd_free_densities",
                    lambda: proposal_sample(gen, bundle, free, cfg.num_proposal_samples_per_ray,
                                            cfg.num_nerf_samples_per_ray))
    bias = torch.zeros((), device=dev, requires_grad=True)

    def sampling_losses():
        bias.grad = None
        fns = [lambda p: p.sum(-1) * 0 + 0.1 + bias] * 2
        s, wl, sl = proposal_sample(gen, bundle, fns, cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray)
        w = render_weights(torch.full(s.positions.shape[:-1], 0.1, device=dev) + bias, s.deltas)
        (L.interlevel_loss(wl, sl, w, s) + 0.002 * L.distortion_loss(w, s)).backward()

    stages.time("sampling_plus_interlevel_distortion_fwd_bwd", sampling_losses)

    def data_step():
        idx = sample_pixels(gen, NUM_RAYS, VIEWS, H, W)
        return cams.generate_rays_at(idx).origins, gather_pixels(images, idx).float() / 255.0

    stages.time("pixel_sample_raygen_gather", data_step)


def signerf_sections(stages: Stages, out: dict, cams, images, dev) -> None:
    base = dict(predict_normals=True, use_lpips=True, use_l1=True, patch_size=PATCH, average_init_density=0.01)
    micro = auto_micro_batches(SIGNERF_RAYS, PATCH, False)
    settings = SamplerSettings(num_rays=SIGNERF_RAYS, patch_size=PATCH, micro_batches=micro)

    def model_of(**kw):
        m = SIGNeRFModel(SIGNeRFModelConfig(**{**base, **kw}), num_train_images=VIEWS)
        return m.reset_parameters(torch.Generator().manual_seed(14)).to(dev)

    smodel = model_of()
    step = train_step_fn(smodel, cams, images, settings)
    t = stages.time(f"signerf_step_total_{SIGNERF_RAYS}rays_patch{PATCH}", step, iters=3)
    out["signerf_train_rays_per_s"] = round(SIGNERF_RAYS / t * 1e3, 1)
    out["signerf_micro_batches"] = micro
    breakdown("signerf_step_kernel_breakdown", step, out)
    for mlabel, m in (("micro1_monolithic", 1), ("micro4", 4)):
        if m != micro:
            stages.time(f"signerf_step_{mlabel}", train_step_fn(
                smodel, cams, images, dataclasses.replace(settings, micro_batches=m)), iters=3)
    for label, kw in (("signerf_step_no_normals", dict(predict_normals=False)),
                      ("signerf_step_no_lpips", dict(use_lpips=False)),
                      ("signerf_step_fast_normals", dict(fast_normals_losses=True))):
        tv = stages.time(label, train_step_fn(model_of(**kw), cams, images, settings), iters=3)
        if t - tv > 0:  # what the subsystem costs; within the noise it is no time
            stages.ms[f"{label}_delta_vs_total"] = round(t - tv, 4)
        else:
            stages.unresolved.append(f"{label}_delta_vs_total")

    gen = torch.Generator(device=dev).manual_seed(20)
    n_patches = SIGNERF_RAYS // (PATCH * PATCH)
    xp = torch.rand(n_patches, PATCH, PATCH, 3, generator=gen, device=dev) * 2 - 1
    yp = torch.rand(n_patches, PATCH, PATCH, 3, generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        stages.time(f"lpips_fwd_{n_patches}patch{PATCH}", lambda: lpips(smodel.lpips_params, xp, yp))

    def lpips_fb():
        x = xp.clone().requires_grad_(True)
        lpips(smodel.lpips_params, x, yp).sum().backward()
        return x.grad

    stages.time(f"lpips_fwd_bwd_{n_patches}patch{PATCH}", lpips_fb)
    stages.time(f"patch_sample_raygen_gather_{SIGNERF_RAYS}", lambda: (
        lambda idx: (cams.generate_rays_at(idx).origins, gather_pixels(images, idx).float() / 255.0))(
            sample_patches(gen, SIGNERF_RAYS, PATCH, VIEWS, H, W)))

    n = SIGNERF_RAYS // micro * smodel.config.num_nerf_samples_per_ray
    posn = torch.rand(n, 3, generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        stages.time(f"normals_density_geo_grad_fwd_N{n}",
                    lambda: factor_density_geo_and_grad(smodel.field, posn, differentiable_grad=True))

    def normals_fb():
        smodel.field.zero_grad()
        d, _, g = factor_density_geo_and_grad(smodel.field, posn, differentiable_grad=True)
        nrm = -g / torch.sqrt((g * g).sum(-1, keepdim=True) + 1e-12)
        (d.sum() + (nrm * 1e-3).sum()).backward()

    stages.time(f"normals_density_geo_grad_fwd_bwd_N{n}", normals_fb)


def main(signerf_only: bool = False) -> dict:
    require_cuda()
    dev = torch.device("cuda")
    cams = cameras(dev)
    images = torch.zeros(VIEWS, H, W, 3, dtype=torch.uint8, device=dev)
    stages, out = Stages(), {}
    if not signerf_only:
        nerfacto_sections(stages, out, cams, images, dev)
    signerf_sections(stages, out, cams, images, dev)
    return {**stages.as_dict(), **out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write the breakdown here")
    ap.add_argument("--signerf", action="store_true", help="the signerf regime alone")
    args = ap.parse_args()
    results = main(args.signerf)
    if args.json:
        write_breakdown(args.json, results, "scripts/profile_train_torch.py",
                        f"ms per optimizer step at {NUM_RAYS} rays (signerf_nerfacto's regime) unless labelled, and "
                        f"of its parts at the same shapes; the signerf regime at {SIGNERF_RAYS} rays; seeded random "
                        "weights, black images; each the median of 5 windows of CUDA events after a warm-up, with "
                        "its range")
