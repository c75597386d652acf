"""Attribute the render hot path of the PyTorch port on the card: the twin of
scripts/profile_render.py.

One 8192-ray render chunk of the full-size nerfacto (seeded random
weights), then its parts at the chunk's shapes: the base field's encode
(K3), each proposal field's fused encode + density MLP (K1), a bf16 MLP
stack, the proposal-sampling machinery with free densities, the two PDF
resamples, `bins_to_ray_samples` and the contraction; and the chunk's
device time by kernel under `torch.profiler`. Each stage is the median of
5 windows of CUDA events after a warm-up, with its range. Usage, from the
repository root, on a card:

    python scripts/profile_render_torch.py [--json RENDER_BREAKDOWN_TORCH.json]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.cameras.cameras import RayBundle  # noqa: E402
from signerf_tpu_torch.models.fields import FactorGridEncoding, HashMLPDensityField  # noqa: E402
from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig  # noqa: E402
from signerf_tpu_torch.models.samplers import (  # noqa: E402
    bins_to_ray_samples,
    make_spacing,
    proposal_sample,
    sample_pdf_bins,
    sample_uniform_bins,
)
from signerf_tpu_torch.ops.contraction import contract  # noqa: E402
from signerf_tpu_torch.ops.factor_grid import FactorGridConfig  # noqa: E402
from signerf_tpu_torch.utils.microbench import Stages, kernel_breakdown, require_cuda, write_breakdown  # noqa: E402

CHUNK = 8192
# Device kernels by name for the chunk's breakdown.
GROUPS = [
    ("K1 fused encode + density MLP", ("density_kernel",)),
    ("K3 encode", ("encode_kernel",)),
    ("GEMMs", ("gemm", "cutlass", "xmma", "matmul")),
    ("sort and search", ("sort", "search", "bucketize")),
    ("reductions and scans", ("reduce", "scan", "cumsum")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def main() -> dict:
    require_cuda()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    cfg = NerfactoModelConfig()
    model = NerfactoModel(cfg, num_train_images=8).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    stages = Stages()
    gen = torch.Generator(device=dev).manual_seed(1)
    dirs = torch.randn(CHUNK, 3, generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    bundle = RayBundle(origins=torch.zeros(CHUNK, 3, device=dev), directions=dirs,
                       pixel_area=torch.full((CHUNK, 1), 1e-6, device=dev),
                       camera_indices=torch.zeros(CHUNK, 1, dtype=torch.int32, device=dev),
                       nears=torch.full((CHUNK, 1), 0.05, device=dev), fars=torch.full((CHUNK, 1), 1000.0, device=dev))
    out = {}
    with torch.inference_mode():
        def chunk():
            return model(bundle)

        t = stages.time(f"full_render_chunk_{CHUNK}_rays", chunk)
        out["rays_per_s"] = round(CHUNK / t * 1e3, 1)
        bd = kernel_breakdown(chunk, GROUPS, iters=5)
        out["chunk_kernel_breakdown"] = {
            "span_ms": round(bd["span_ms"], 4), "busy_ms": round(bd["busy_ms"], 4),
            "idle_share": round(bd["idle_share"], 4),
            "groups_ms": {k: round(v, 4) for k, v in bd["groups_ms"].items()}, "spans": bd["spans"]}
        print(f"  chunk under the profiler: span {bd['span_ms']:.3f} ms, device busy {bd['busy_ms']:.3f} ms, idle "
              f"{bd['idle_share']:.1%}; " + "; ".join(f"{k} {v:.3f}" for k, v in bd["groups_ms"].items()), flush=True)

        n = CHUNK * cfg.num_nerf_samples_per_ray
        enc = FactorGridEncoding(FactorGridConfig(num_levels=8, base_res=16, max_res=cfg.max_res, features_per_level=16))
        enc.reset_parameters(torch.Generator().manual_seed(3))
        enc = enc.to(dev)
        x = torch.rand(n, 3, generator=gen, device=dev)
        stages.time("final_field_encode", lambda: enc(x))

        for i, (ns, mres) in enumerate(zip(cfg.num_proposal_samples_per_ray, (128, 256))):
            prop = HashMLPDensityField(max_res=mres, num_levels=5)
            prop.reset_parameters(torch.Generator().manual_seed(5))
            prop = prop.to(dev)
            pos = torch.rand(CHUNK * ns, 3, generator=gen, device=dev) * 2 - 1
            stages.time(f"proposal{i}_field_fused_encode_density", lambda p=prop, q=pos: p(q))

        w0 = torch.randn(128, 64, generator=gen, device=dev).bfloat16()
        w1 = torch.randn(64, 64, generator=gen, device=dev).bfloat16()
        x0 = torch.randn(n, 128, generator=gen, device=dev).bfloat16()

        def mlp():
            h = torch.relu(x0 @ w0)
            for _ in range(4):
                h = torch.relu(h @ w1)
            return h

        stages.time("mlp_5layer_64wide", mlp)

        free = [lambda p: p.sum(-1) * 0 + 0.1] * 2
        stages.time("sampling_machinery_free_densities",
                    lambda: proposal_sample(gen, bundle, free, num_proposal_samples=cfg.num_proposal_samples_per_ray,
                                            num_nerf_samples=cfg.num_nerf_samples_per_ray))
        s_to_t, _ = make_spacing(bundle.nears, bundle.fars)
        first, second = cfg.num_proposal_samples_per_ray
        for s_from, q_to in ((first, second), (second, cfg.num_nerf_samples_per_ray)):
            bins = sample_uniform_bins(gen, CHUNK, s_from, device=dev)
            w = torch.rand(CHUNK, s_from, generator=gen, device=dev)
            stages.time(f"pdf_resample_{s_from}_to_{q_to}", lambda b=bins, ww=w, q=q_to: sample_pdf_bins(gen, b, ww, q))
        bins = sample_uniform_bins(gen, CHUNK, first, device=dev)
        stages.time("bins_to_ray_samples_positions", lambda: bins_to_ray_samples(bundle, bins, s_to_t).positions)
        pos = torch.randn(CHUNK * first, 3, generator=gen, device=dev)
        stages.time("contraction", lambda: contract(pos))
    return {**stages.as_dict(), **out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write the breakdown here")
    args = ap.parse_args()
    results = main()
    if args.json:
        write_breakdown(args.json, results, "scripts/profile_render_torch.py",
                        f"ms per {CHUNK}-ray render chunk of the full-size nerfacto (seeded random weights) and of its "
                        "parts at the chunk's shapes; each the median of 5 windows of CUDA events after a warm-up, "
                        "with its range")
