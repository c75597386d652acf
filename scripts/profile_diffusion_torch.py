"""Attribute the sheet-scale SDXL inpaint of the PyTorch port on the card: the
twin of scripts/profile_diffusion.py.

SDXL + ControlNet-depth at the published widths (seeded random bf16
weights: the shapes and the work are real) inpaints a 3x3 sheet of 512 px
cells (1536 px, a 192 x 192 latent), as the edit pass's reference sheet
and each per-view call do:

  * 20-step and 4-step inpaint walls (host clock around work that ends in
    `torch.cuda.synchronize()`, the least of 3 after a warm-up), and from
    their difference over the sampler steps each ran (strength 0.9: 18 and
    3) a step's marginal and the rest (VAE, prompt, blends); the sampler
    step's median from the pipeline's own CUDA events; the walls again with
    the windowed last-cell VAE (`prepare_sheet_cache`);
  * the VAE's encode and decode of the whole sheet and of the window, and
    the uncached prompt encode;
  * self-attention at the sheet's two shapes (S = 9216 with 10 heads,
    S = 2304 with 20), K7 (the port's flash-attention kernel) against
    PyTorch's `scaled_dot_product_attention`;
  * one 4-step inpaint by kernel under `torch.profiler`.

CUDA-event stages are the median of 5 windows after a warm-up, with their
range. Usage, from the repository root, on a card:

    python scripts/profile_diffusion_torch.py [--json DIFFUSION_BREAKDOWN_TORCH.json]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from signerf_tpu_torch.diffusion.sdxl_pipeline import SDXLInpaintPipeline  # noqa: E402
from signerf_tpu_torch.ops import flash_attention as fa  # noqa: E402
from signerf_tpu_torch.utils.microbench import Stages, kernel_breakdown, require_cuda, write_breakdown  # noqa: E402

SHEET, CELL = 1536, 512
GROUPS = [
    ("K7 self-attention", ("flash_attention_kernel",)),
    ("convolutions", ("conv", "cudnn", "implicit_gemm", "winograd", "fft")),
    ("GEMMs", ("gemm", "cutlass", "xmma", "matmul")),
    ("normalisation", ("norm",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def main() -> dict:
    require_cuda()
    dev = torch.device("cuda")
    pipe = SDXLInpaintPipeline.create(device=dev)
    stages, out = Stages(), {}
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((SHEET, SHEET, 3), np.float32), device=dev)
    mask = torch.zeros(SHEET, SHEET, 1, device=dev)
    mask[-CELL:, -CELL:] = 1.0  # the last cell: the spliced view
    cond = torch.as_tensor(rng.random((SHEET, SHEET, 1), np.float32), device=dev)

    def wall(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    def inpaint(steps, cache=None):
        return lambda: pipe.img2img(img, "a photo", mask=mask, control_image=cond, num_steps=steps, seed=1,
                                    device_out=True, sheet_cache=cache)

    def step_median() -> float:
        ev = pipe.last_run["step_events"]
        ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1))
        return ms[len(ms) // 2] if ms else float("nan")

    with torch.inference_mode():
        cache = pipe.prepare_sheet_cache(img, (CELL, CELL))
        for suffix, c in (("", None), ("_windowed_vae", cache)):
            t20 = wall(inpaint(20, c))
            med, n20 = step_median(), pipe.last_run["sampler_steps"]
            t4 = wall(inpaint(4, c))
            n4 = pipe.last_run["sampler_steps"]  # strength 0.9 runs 18 and 3 of the 20 and 4 steps
            per_step = (t20 - t4) / (n20 - n4)
            for label, ms in ((f"inpaint_20step_total{suffix}", t20), (f"inpaint_4step_total{suffix}", t4),
                              (f"sampler_step_median_cuda_events{suffix}", med),
                              (f"unet_step_marginal_seqcfg{suffix}", per_step),
                              (f"vae_prompt_blend_overhead{suffix}", t4 - n4 * per_step)):
                if ms > 0:
                    stages.ms[label] = round(ms, 4)
                else:
                    stages.unresolved.append(label)
            print(f"  inpaint{suffix}: 20 steps {t20:.1f} ms, 4 steps {t4:.1f} ms, sampler step median {med:.2f} ms "
                  f"(CUDA events), marginal {per_step:.2f} ms", flush=True)
        out["note_cfg"] = ("a sampler step is two sequential CFG branches (uncond + cond) at the sheet's size, each "
                           "a ControlNet + UNet forward")

        vae = pipe.vae
        x = img[None] * 2 - 1
        z = vae.encode(x)
        stages.time("vae_encode_full_sheet", lambda: vae.encode(x), iters=3)
        stages.time("vae_decode_full_sheet", lambda: vae.decode(z), iters=3)
        eh, ew, sp_h, sp_w, dh, dw = cache.window_lat
        f = pipe.config.vae_downscale
        win = x[:, -eh * f:, -ew * f:, :]

        def enc_win():
            feats = cache.down_feats.clone()
            feats[:, -sp_h:, -sp_w:, :] = vae.encode_down(win)[:, -sp_h:, -sp_w:, :].to(feats.dtype)
            return vae.encode_from_features(feats)

        stages.time("vae_encode_windowed", enc_win, iters=3)
        stages.time("vae_decode_windowed", lambda: vae.decode_up(vae.decode_mid(z)[:, -dh:, -dw:, :]), iters=3)
        pipe._prompt_cache.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.encode_prompt("a photo", "")
        torch.cuda.synchronize()
        stages.ms["prompt_encode_uncached"] = round((time.perf_counter() - t0) * 1e3, 4)

        lat = SHEET // f
        gen = torch.Generator(device=dev).manual_seed(0)
        for s, heads in (((lat // 2) ** 2, 10), ((lat // 4) ** 2, 20)):
            q, k, v = (torch.randn(1, s, heads, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            stages.time(f"attn_S{s}_h{heads}_k7", lambda: fa.flash_attention_cuda(q, k, v, 0.125), iters=20)
            stages.time(f"attn_S{s}_h{heads}_sdpa",
                        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=0.125), iters=20)

        bd = kernel_breakdown(inpaint(4), GROUPS, iters=1)
        out["inpaint_4step_kernel_breakdown"] = {
            "span_ms": round(bd["span_ms"], 4), "busy_ms": round(bd["busy_ms"], 4),
            "idle_share": round(bd["idle_share"], 4),
            "groups_ms": {k: round(v, 4) for k, v in bd["groups_ms"].items()}}
        print(f"  4-step inpaint under the profiler: span {bd['span_ms']:.1f} ms, device busy {bd['busy_ms']:.1f} ms, "
              f"idle {bd['idle_share']:.1%}; " + "; ".join(f"{k} {v:.2f}" for k, v in bd["groups_ms"].items()),
              flush=True)
    return {**stages.as_dict(), **out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write the breakdown here")
    args = ap.parse_args()
    results = main()
    if args.json:
        write_breakdown(args.json, results, "scripts/profile_diffusion_torch.py",
                        f"ms at the 3x3 sheet of {CELL} px cells ({SHEET} px, a {SHEET // 8} px latent), SDXL + "
                        "ControlNet-depth at the published widths with seeded random bf16 weights; walls are host "
                        "clocks around synchronised work, the rest CUDA events")
