#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (any failure exits non-zero before
the result line):

  1. environment: card name and power limit, torch / CUDA / nvcc versions,
     image libraries present;
  2. build K1 to K10 (signerf_tpu_torch/csrc/fused_factor_{density,
     density_bwd,encode,grad_dot,grad}.cu and flash_attention.cu), all six
     nvcc processes at once, with ptxas's registers, shared memory, spills
     and warnings (K7 fails on C7508 or C7513; K1, K3, K5, K10, K9's
     tables half and the coords halves of K2, K4 (both instantiations of
     K5's tile loop) and K6 on spills), and a line for K5's, K9's tables
     and the three coords halves' kernels;
  3. K1 against its plain PyTorch twin on the card, per call for each of
     the three density fields at the sample counts of one 8192-ray render
     chunk and of one 4096-ray train step, each at three layouts of the
     samples (uniform, ray-ordered, one cell), plus N = 257 with u in
     {0, 1}: error, CUDA-event times and each call's bound;
  4. K2 (both halves) against its plain twin at the sample counts of one
     4096-ray train step, plus N = 257: per-leaf error and times, both
     halves also at ray-ordered coordinates (each ray's samples in order,
     as a train step lays them out) and with every sample in one cell (the
     tables half there against the twin's terms summed in float64, beside
     the twin's own error), the coords half with its share of the bound and
     its worst error; each schedule's share of the step, the run-to-run
     spread, the tables kernel's shared memory and blocks per SM;
  5. K3, K4 (both halves), K5 and K6 (both halves) against their plain twins
     at one `signerf` micro-batch's base-field shapes (N = 196,608, uniform
     and clustered coordinates) and at N = 257 and 1003 with u in {0, 1}
     (K5 and the coords halves of K4 and K6 exactly 0 on an axis at a
     knot): error, CUDA-event times and shares of the bound; then
     the tables halves of K4 and K6 (and grad_g) at three layouts, uniform,
     ray-ordered (48 samples a ray in ray order) and every sample in one
     cell (there against the twin's terms summed in float64, beside the
     twin's own error): error, run-to-run spread of the line grads and
     times; K3, K5 and the coords halves of K4 and K6 at the three layouts
     with their shares of the bound, and K3 and K5 at the `signerf` eval
     render's chunk (N = 393,216);
 5b. K8, K9 (both halves) and K10 against their plain twins at the same
     shapes, with the cross-checks K8 . g = K5, K9 on ct = g (x) c = K6 and
     K10 = K3 within the bf16 rounding of K10's tap weights; K9's tables
     half at the three layouts (in one cell against the twin's terms
     summed in float64), with the run-to-run spread of its line grads and
     its share of the bound; K10 and K4 at the proposal schedule (their
     5-level instantiations; K4's coords half exactly 0 at the knots), K10
     and both halves of K4 there timed against their twins and bounds,
     and K4's coords half also at the three layouts (256 samples a ray
     ray-ordered) with its share of the bound;
  6. the render CLI at the full width of `signerf_nerfacto` on a synthetic
     512x512 scene (--arc 2 --device cuda, seeded random weights): K1's
     launches must be 3 x chunks; the PNGs must equal a direct render's
     output; outputs finite, accumulation in [0, 1]; rays/s; then one chunk
     again with the plain twin in place of the kernel;
  7. the train CLI (`signerf_nerfacto --train-only True --device cuda`) for
     300 steps at full width on the same scene: finite, falling loss; K1 and
     K2's tables half launched 3 x steps, K2's coords half never; warm
     rays/s, step times, peak memory;
  8. a few steps with camera opt on: K2's coords half 3 x steps;
  9. one step's gradients with both plain twins in place of K1 and K2;
 10. the trained checkpoint through the render and eval CLIs (PSNR);
 11. the train CLI for `signerf --train-only True --device cuda` at full
     width (16,384 rays as 16 patches of 32x32, 4 micro-batches, L1 + LPIPS
     with random alex weights and the uncalibrated warning, normals and
     both normals losses): finite, falling loss; K3, K5 and the tables
     halves of K4 and K6 launched 4 x steps, K1 and K2's tables half
     8 x steps, no coords half; warm rays/s, step times, peak memory;
 12. two `signerf` steps with camera opt on: the coords halves of K2, K4
     and K6 launch;
 13. one `signerf` micro-batch's gradients with all six plain twins in place
     of the kernels; finite normals; the orientation loss alone reaches the
     line tables; a profile of warm train steps (device time per kernel,
     K4's and K6's a call);
 14. one full-frame eval render of the trained `signerf` model through
     `make_eval_render`: K3 = K5 = chunks, K1 = 2 x chunks, outputs finite;
 14b. the entry points of K8 to K10 on the trained `signerf` base field's
     line tables at one micro-batch of clustered coordinates:
     `grad_encode_fused` forward and backward (K8, both halves of K9),
     `fused_factor_grad` (K8), `factor_encode_kernel` forward and backward
     (K10, both halves of K4); exact launch counts; against the same calls
     on the plain twins;
 14c. the reference sheet: `signerf_nerfacto` trained 300 steps by the train
     CLI on the scene with a grey backdrop (white background colour: on the
     white scene the NeRF learns no geometry; while a view's mask is empty,
     a fresh NeRF of 600, then 900 steps, each run's count of empty masks
     printed), its 8 views rendered at
     512 px through `make_eval_render` (K1), AABB
     masks and conditions (dilation (50, 50)), a `bunny(3)` proxy posed with
     `object_pose_matrix` and ray-traced by `geometry/raster.py` into shape
     masks and conditions, the AABB set composed into a 3x3 sheet of 512 px
     cells; mask coverage,
     raster, dilation and compose times, `resize_mask` flips against the
     CPU at 512 -> 256; no cell's mask may be empty; phase 7's NeRF under
     the same box, for comparison;
 14d. the edit pass, SIGNeRF's product path, through the trainer API on
     phase 14c's scene: `signerf_nerfacto` at its defaults trained 300
     steps; `generate_dataset` at the generator's defaults (2x3 sheet of
     256 px cells, downscale 2, generation_batch_size 4,
     lastcell_vae_window) and the Diffuser's but 5 steps (torch_sdxl,
     strength 0.9, CFG 7, ControlNet 0.8) on SDXL at random init, with 5
     reference poses on a circle and the 8 cameras' PNGs as originals;
     `exchange_training_dataset`; 300 refinement steps. Checks
     transforms.json (5 + 8 frames), every PNG of the schema at full and
     cell size, the dataparser's read-back, step 0 and the surgery after
     the exchange (proposal networks from the seeded init, the rest the
     checkpoint's), a finite, falling refinement loss, and exact launches:
     K1 3 x chunks x 13 renders, K7 from the pipeline's schedule, K1 and
     K2's tables half 3 x steps in training and refinement; walls of each
     phase and chunk, peak memory;
 14e. the headless train CLI on the generated dataset (`--skip-interface
     True --skip-generation True`, 50 steps), `export pointcloud` and
     `export mesh` on the refined checkpoint, each with exact K1 launches;
 14f. the interface on phase 14c's scene and checkpoint at the defaults:
     the train CLI without --skip-interface in a subprocess (its viewer on
     port 7007: /state, one /render, then terminated); then in process the
     viewer over a trainer: paused /render at 128, 256 and 512 px (request,
     lock wait, render and PNG encode; K1 3 x chunks each), 300 training
     steps without and 300 with a client at 2 fps (every reply at the
     throttled size, a pause and a resume; step medians), /export of a mesh
     at 64^3 and of a point cloud, /params (EDIT_SDXL_STEPS), /preview
     (SDXL created in it) and /generate until the refinement (300 steps)
     completes, each with exact
     K1, K2-tables and K7 launches (K7 from the pipeline's schedule), the
     dataset schema, peak memory;
 14g. the hash-grid backend (`encoding_backend="hash"`, nerfacto's own
     encoding, plain PyTorch: K1 to K10 launch 0 times on every hash
     path) at its published widths: (a) `hashgrid_encode` alone for the
     base table (16 x 2 from 2^19, 16 to 2048) and both proposal tables
     (5 x 2 from 2^17, to 128 and 256) at a render chunk's and a 4096-ray
     train step's N, forward and forward + backward against a bytes bound
     (32-byte sectors for the base table's hashed levels), and against
     float64 and float32 on the CPU at N = 4096; (b) the render CLI with
     `--model.encoding-backend hash` on phase 6's scene, rays/s and warm
     frame median; (c) the `signerf_nerfacto` train CLI with the hash
     backend for 150 steps on 14c's scene (step median, rays/s, peak
     memory), PSNR and accumulation of its 8 views beside 14c's factor
     NeRF (rays in the scene box, and between the near and far planes),
     both export subcommands on its checkpoint; (d) the `signerf` train
     CLI with the hash backend, 4 steps at 16,384 rays, then finite
     normals and a nonzero base-table gradient from the orientation loss
     alone; and two identical 10-step hash runs from one seed, their
     per-step |d loss|; the phase's wall;
 15. K7 (signerf_tpu_torch/csrc/flash_attention.cu) against its plain twin
     and an f32 reference at (B, S, H) = (1, 9216, 10), (1, 2304, 20),
     (2, 2304, 20), (1, 4096, 10), (1, 1000, 10), (3, 77, 2), (1, 1, 1),
     the edit pass's (2, 1536, 10), (2, 384, 20), (8, 1536, 10),
     (8, 384, 20), phase 24's and 25(b)'s at a rank's heads (K7_TP_SHAPES,
     K7_TP_EDIT_SHAPES: 5 and 10 heads) and phase 22's pass's 768 px sheet
     (K7_PASS_SHAPES); CUDA-event times of the kernel, the twin and
     scaled_dot_product_attention (a yardstick the port never calls) beside
     the bound; a line for each sheet and edit-pass shape: kernel, SDPA,
     their ratio, TFLOP/s and share of the bound;
 16. the full SDXL + ControlNet-depth stack at random init in bf16 on the
     card, then `Diffuser.diffuse` at the defaults (20 steps, strength 0.9,
     CFG 7, ControlNet 0.8, Euler a) on phase 14c's 1536 px reference
     sheet: sequential CFG, exactly 208 K7 launches a sampler step (3,744),
     sampler step times, peak memory, a finite [1536, 1536, 3] output in
     [0, 1], blended with the mask and split into its 8 cells;
 17. the per-view fast path: `prepare_sheet_cache`, then dataset view 3
     spliced into the last cell (`splice_last_cell`) through the windowed
     encode and decode (num_inference_steps cut to 5);
 18. one CFG branch at the sheet shape through K7 and through the twin;
 19. a profile of one sampler step's model work: device busy share, K7's
     share, the top kernels;
 21. the JAX package's last modules and knobs (run after 14g, (e) and (f)
     after 19): (a) K3 and K4's tables half at the proposal fields'
     train-step and render-chunk sample counts against their twins, then
     `signerf_nerfacto` with linear proposal networks (`use_linear`)
     through the train CLI, 300 steps on 14c's scene (K1 and K2's tables
     half once a step for the base field, K3 and K4's tables half twice
     for the proposal fields), its views' PSNR beside 14c's NeRF and one
     512 px frame through the render CLI; (b) a 10-camera
     `CameraArcDataset` at 512 px rendered from phase 7's checkpoint over
     `FixedIndicesEvalCameraDataloader`; (c) `FactorGridEncoding` with
     planes (the JAX defaults) and (d) `encode_with_grad` on phase 7's
     base-field lines at N = 196,608, forward and backward, against the
     twins; (g) `CachedImageStore` on the card against numpy's draws; (h)
     the FLOP model's counts and shares at the measured rays/s; two
     identical 10-step factor runs' per-step |d loss|; (e) the SDXL VAE's
     posterior sample at 1024 px; (f) the full SDXL pipeline written in
     the JAX package's msgpack layout (f32, ~18.9 GB, by this script's own
     writer of flax's format), read by `SDXLInpaintPipeline.create`, every
     tensor checked, one 1536 px sheet sampler step on it (K7); exact
     launches in each;
 22. the repository's example scripts and the probe (run after 21):
     examples/fit_synthetic_torch.py's `main` (5 dispatches of 50 steps at
     4096 rays on its 16-view analytic scene: eval PSNR, rays/s, exact K1
     and K2 launches); the pretrain's kernels at its shapes, which phases 3
     to 5 do not time (K1 and K2's tables half at the proposal fields, K3,
     K5 and the tables halves of K4 and K6 at the base field, for a
     micro-batch of 16,384 rays), against their twins, with times and
     bounds; scripts/probe_edit_mask_torch.py's pretrain of the pass's
     NeRF on its 100-view ring at 512 px, `signerf` steps of 16,384 rays in
     one micro-batch until every reference mask is non-empty (checks at
     1000, 1300, 1600, 2000 and 2500 steps);
     examples/north_star_pass_torch.py's
     `main` at 2 views of 512 px from that checkpoint (its 3x3 sheet of
     256 px cells, full-width SDXL at random init, 5 steps (20 in the
     script), 100 refinement steps; K7's shapes on that sheet timed by phase 15): the result's keys against the JAX script's schema,
     every number finite, a non-empty edit mask, exact K1 to K6 launches
     and K7 from the pipeline's schedule, the walls of each phase;
 23. data parallelism over the visible cards (run after 22), one process a
     card on torch.distributed: (a) the `signerf` train CLI with `--mesh
     data` over NCCL on all W cards (on one card a process group of 1,
     which still runs the all-reduce), 50 steps of 16,384 global rays on
     14c's scene: each rank's exact launches (its micro-batches of 4096
     rays), step median, wall and peak memory, and every rank's final
     parameters equal to rank 0's; (b) at max(W, 2) ranks (NCCL with a card
     a rank on W >= 2 cards, else gloo with both ranks on cuda:0; the
     backend printed): 4 DP `signerf_nerfacto` steps from fed indices
     against one rank on the concatenated indices (loss and parameters
     within DP_LOSS_RTOL and DP_PARAM_TOL), a 512 px frame against one
     rank's bit for bit, and the per-view generation of 4 views of 512 px
     through SDXL at published widths (random init, 3 steps, batch 2) on
     the ranks against one rank's dataset by tests/test_torch_edit_flow.py's
     `assert_same_dataset` rule;
 24. tensor parallelism (run after 23): max(W, 2) ranks with tensor=2 (NCCL
     a card a rank on W >= 2 cards, else two gloo ranks on cuda:0; the
     backend printed), SDXL at published widths and random init with its
     UNet and ControlNet sharded over each tensor group of 2 ranks: (a) one
     CFG branch at the 1536 px sheet shape against phase 18's one-rank
     branch (norm-relative, TP_BRANCH_TOL); (b) `Diffuser.diffuse` on a
     2x2 sheet of 512 px cells (14c's top-left cells), 3 steps, against
     one rank's on phase 16's pipeline (mean |err|, TP_SHEET_MEAN); (c) the
     per-view generation of 23(b) on the (W / 2, 2) mesh against 23(b)'s
     one-rank dataset (TP_GEN_*); each rank's outputs bit-equal to its
     tensor group's, K7's exact launches by shape at the rank's local heads
     (5 and 10), sharded and whole bytes, walls, step medians and peak
     memory;
 25. the viewer on a mesh of ranks (run after 14f, on 14c's scene and
     checkpoint): the train CLI's own work without --train-only or
     --skip-interface on (a) (data, tensor) = (2, 1) and (b) (1, 2), two
     ranks (gloo on cuda:0 on one card, NCCL a card a rank on more),
     `signerf_nerfacto` at its registered widths, 8192 global rays a step,
     SDXL + ControlNet-depth at published widths and random init (1 sampler
     step a call); rank 0 serves on a port of its own and a client thread
     there drives every route: a bad /nudge (400, and the next command
     runs), /nudge of the reference ring, paused /render at 128 and 512 px,
     /scene, /preview, /generate (300 refinement steps, a client at
     VIEWER_CLIENT_FPS in their second half, a pause and a resume),
     /export of both kinds, /render; exact launches on every rank (K1 on
     rank 0 alone for each /render and export; K7 by shape from the
     pipeline's schedule, at a rank's heads on (1, 2)), parameters equal on
     every rank at the pause and after the refinement, the step median
     with and without the client, lock wait and render during training,
     the control word's ms a call, /preview and /generate walls, the
     dataset schema; (c) on four cards or more also (W, 1) at phase 14f's
     settings, its /generate against 14f's one-rank wall;
 20. a JSON line per kernel, then {"ok": true, "device": {...}} last. A
     kernel's launches are summed over the main path's phases that run it
     (K1: 6, 7, 11, 14, 14d, 14e, 14f, 21, 22, 23 and 25; K2's tables half:
     7, 11, 14d, 14e, 14f, 21, 22, 23 and 25; K3: 11, 14, 21, 22 and 23;
     K4's tables half: 11, 21, 22 and 23; K5: 11, 14, 22 and 23; K6's
     tables half: 11, 22 and 23; K7: 16, 14d, 14f, 21, 22, 24 and 25; K8
     and K9's tables half: 14b and 21; of phases 23 to 25 rank 0's, and of
     25 its (a) and (b): (c) runs 1024 rays a rank, a step N that phase 3
     did not time), and its times
     and bound are per call, each kind of call weighted by its launches,
     so that launches x (ms - bound_ms) is the time the path loses to it;
     a line of each phase's wall.

Phases 1 to 22 run on one card (their CLIs with `--mesh none`) whatever
the host holds; the last line's count is every visible card. Phase 25 runs
right after 14f, on 14c's scene and checkpoint.

The script imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

from signerf_tpu_torch.utils.microbench import TRAIN_KERNEL_GROUPS, cuda_ms, kernel_breakdown

ROOT = Path(__file__).resolve().parent
# K1 vs plain twin, max abs error over max|ref|: the same bf16 features bit
# for bit, but the tensor cores' f32 sums run in another order than the
# twin's, which can flip a bf16 rounding of h or of the output (1/256
# relative), which layer 1 carries on. Measured worst on the H100: 0.0060
# in this phase, 0.0066 on other seeded inputs (PERF.md); 1% of the output
# range.
KERNEL_TOL = 0.01
# One render chunk, kernel vs plain twin: a flipped density rounding moves
# the resampled proposals a little; rgb and accumulation are in [0, 1].
CHUNK_TOL = 0.02
CHUNK = 8192
SCENE = dict(cameras=8, width=512, height=512, arc=2)
RENDER_REPEATS = 5  # warm passes over the arc for the rays/s median
# K2 vs plain twin, per leaf (line grads, dW0, db0, dW1, db1, coords):
# same contract, f32 sums in another order (atomics): norm-relative.
K2_TOL = 1e-4
# Samples of one 4096-ray train step: (name, schedule, samples per ray).
TRAIN_RAYS = 4096
TRAIN_SCHEDULES = [
    ("proposal", (5, 128, 8, 16, 1), 256),
    ("prop256", (5, 256, 8, 16, 1), 96),
    ("final", (8, 2048, 16, 64, 16), 48),
]
SPHERE_RADIUS = 0.6
# The eval CLI's PSNR after TRAIN_STEPS steps must beat the seeded init's by
# this much. On this scene (81% white background, far plane 1000) both
# packages plateau near MSE 0.066 within 200 steps (a CPU run at 48x48), so
# the gate is the gain, not an absolute PSNR.
EVAL_GAIN_DB = 3.0
TRAIN_STEPS = 300  # short runs miss the density NaNs that 300+ steps show
CAMERA_OPT_STEPS = 4
# One step's gradients, kernels vs plain twins (same params, same pixels,
# deterministic sampling): per-leaf norm-relative. A flipped bf16 rounding
# in the forward moves a resampled bin a little, which moves some grads.
STEP_TOL = 0.05
# The `signerf` method: 16,384 rays a step as 32x32 patches, 4 micro-batches
# of 4096 rays x 48 base-field samples.
SIGNERF_RAYS = 16384
SIGNERF_MICRO = 4
SIGNERF_SAMPLES = SIGNERF_RAYS // SIGNERF_MICRO * 48
# The proposal schedule's calls of K10 and K4 in phase 5b: a render chunk's
# samples of the first proposal field (256 a ray).
PROPOSAL_SAMPLES = CHUNK * 256
SIGNERF_STEPS = 100  # not 300: the later phases need the smoke's time
SIGNERF_CAMERA_OPT_STEPS = 2
BASE_SCHEDULE = (8, 2048, 16)  # levels, max_res, F of the base field
# K3 to K6 vs their plain twins: the same f32 formulas on the same bf16
# tables; FMA contraction and summation order move the last bits only.
# K3, max abs error over max|ref|: a product of three lerps differs by a few
# ulps (~1e-6). K4, K5, K6, norm-relative per leaf: f32 sums in another
# order, and atomics in the tables halves, as K2 (K2_TOL).
K3_TOL = 1e-5
K456_TOL = 1e-4
# K8 and K9 against their twins as K4 to K6, K10 as K3. K10 against K3: the
# bf16 rounding of K10's tap weights (2^-9 relative a weight, three axes)
# bounds their difference at 1% of max|K3|.
K10_K3_TOL = 0.01
PROFILE_STEPS = 3
# Published H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
# every bound below is against these, with the card's power limit beside it.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0):
    """(least ms, "bytes" | "operations") of one call: each input read once
    and each output written once over HBM's rate, against its operations
    over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_bound(stats: dict, call, key: str = "") -> None:
    """Add one call's bound to stats[f"bound_ms{key}"]; bound_by follows the
    largest call."""
    ms, kind = call
    stats[f"bound_ms{key}"] = stats.get(f"bound_ms{key}", 0.0) + ms
    if ms >= stats.get(f"_largest{key}", -1.0):
        stats[f"_largest{key}"], stats[f"bound_by{key}"] = ms, kind


def factor_bounds(res, feat, tables, n, hidden=0, out=0):
    """Bounds of K1 to K6 on one call's inputs (N samples, L levels of F
    features, D = L F; an MLP of `hidden` and `out` for K1 and K2). The f32
    operation counts are the taps' lerps and products (11 L F a sample
    forward, about as many again backward); K1 and K2's MLP runs in bf16."""
    lf = len(res) * feat
    d = lf
    tab = tables.numel() * 2
    grads = tables.numel() * 4
    mlp_w = 2 * (d * hidden + hidden + hidden * out + out)
    mlp = 2 * n * (d * hidden + hidden * out)
    enc, enc_bwd = 11 * lf * n, 12 * lf * n
    x, g_feat = 12 * n, 4 * n * d
    return {
        "K1": bound(x + tab + mlp_w + 4 * n * out, mlp, enc),
        "K2 tables": bound(x + 4 * n * out + tab + mlp_w + grads + 2 * mlp_w, 3 * mlp, enc + enc_bwd),
        "K2 coords": bound(x + 4 * n * out + tab + mlp_w + x, 3 * mlp, enc + enc_bwd),
        "K3": bound(x + tab + g_feat, 0, enc),
        "K4 tables": bound(x + g_feat + tab + grads, 0, enc + enc_bwd),
        "K4 coords": bound(x + g_feat + tab + x, 0, enc + enc_bwd),
        "K5": bound(x + g_feat + tab + x, 0, enc + enc_bwd),
        "K6 tables": bound(x + g_feat + x + tab + grads + g_feat, 0, enc + 2 * enc_bwd),
        "K6 coords": bound(x + g_feat + x + tab + x, 0, enc + 2 * enc_bwd),
    }


def grad_bounds(res, feat, tables, n):
    """Bounds of K8, K9 and K10 on one call's inputs: K8's [N, 3, D] f32
    output and K9's cotangent of that shape dominate the bytes; the f32
    operation counts are the taps' lerps and slopes and the products
    (approximate, as factor_bounds')."""
    d = len(res) * feat
    tab, grads = tables.numel() * 2, tables.numel() * 4
    x, ct = 12 * n, 12 * n * d
    enc, enc_bwd = 11 * d * n, 12 * d * n
    return {
        "K8": bound(x + tab + ct, 0, enc + 6 * d * n),
        "K9 tables": bound(x + ct + tab + grads, 0, enc + 3 * enc_bwd),
        "K9 coords": bound(x + ct + tab + x, 0, enc + 2 * enc_bwd),
        "K10": bound(x + tab + 4 * n * d, 0, enc),
    }



def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def read_png(path: Path):
    """Decode an 8-bit PNG with filter type 0 on every row, as the port's
    writer produces (gray or RGB)."""
    import numpy as np

    data = path.read_bytes()
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            channels = {0: 1, 2: 3}[color]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        fail(f"{path.name}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, channels)


def phase_environment(torch) -> str:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    print(card)  # the card's name and power limit, as nvidia-smi gives them
    from signerf_tpu_torch.ops import cuda_build

    nvcc = run([cuda_build.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import PIL  # noqa: F401

        pillow = "yes"
    except ImportError:
        pillow = "no"
    try:  # the JAX package's native PNG codec; the port does not need it
        ctypes.CDLL(str(ROOT / "native" / "libimage_codec.so"))
        codec = "loads"
    except OSError:
        codec = "does not load"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"phase 1 environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc '{nvcc}', devices {torch.cuda.device_count()}, "
        f"Pillow {pillow}, native codec {codec}, PNG writer: the port's own (zlib), tf32 off"
    )
    return card


# Kernels whose ptxas report phase 2 checks for spills (a substring of the
# entry's name); it prints the registers of all but the first two. K5's
# tile loop runs in three: K5's, K6's coords half's and K4's coords half's
# (`encode_bwd_dot_kernel`, at the base field and the proposal schedule).
NO_SPILL = ("density_kernel", "encode_kernel", "grad_dot_kernel", "grad_bwd_tables_kernel",
            "density_bwd_coords_kernel", "grad_dot_bwd_coords_kernel", "encode_bwd_dot_kernel")


def phase_build():
    """Build every kernel; print ptxas's registers, shared memory, spills and
    warnings. K7 must keep its register split (no C7508: setmaxnreg
    ignored) and its wgmma pipeline (no C7513: wgmma serialized)."""
    from signerf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.library("flash_attention")  # builds and loads every source
    secs = time.perf_counter() - t0
    log = cuda_build.build_log.splitlines()
    usage = [
        ln.strip().removeprefix("ptxas info    : ")
        for ln in log
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln or "(C75" in ln
    ]
    print(f"phase 2 build K1 to K10 ({len(cuda_build.SOURCES)} nvcc at once): {secs:.2f} s into "
          f"{cuda_build.BUILD_DIR} | " + " | ".join(usage))
    # The kernels on the encode tile (K1, K3, K5, K10), K9's tables half and
    # the coords halves of K2, K4 (both instantiations) and K6 keep their
    # registers: no spills.
    reports = {}
    for i, ln in enumerate(log):
        if "Compiling entry" in ln and any(k in ln for k in NO_SPILL):
            rest = [x.strip().removeprefix("ptxas info    : ") for x in log[i + 1 : i + 4]
                    if "registers" in x or "spill" in x]
            spill = next((x for x in rest if "spill stores" in x), "")
            if spill and " 0 bytes spill stores" not in spill:
                fail(f"ptxas spills in {ln.split(chr(39))[1]}: {spill}")
            for k in NO_SPILL[2:]:
                if k in ln:
                    reports.setdefault(k, []).append("; ".join(rest))
    if reports:
        print("phase 2 " + " | ".join(f"{k}: " + " / ".join(v) for k, v in reports.items()), flush=True)
    entry = next((i for i, ln in enumerate(log) if "Compiling entry" in ln and "flash_attention_kernel" in ln), None)
    if entry is None:
        print("phase 2 K7: flash_attention.so came from the cache of an earlier build, its ptxas report was "
              "not checked in this run", flush=True)
        return
    regs = next(ln.split(":", 1)[1].strip() for ln in log[entry:] if "registers" in ln)
    # Only K7 issues setmaxnreg and wgmma: every such warning is its own.
    warned = [ln.strip() for ln in log if "C7508" in ln or "C7513" in ln]
    print(f"phase 2 K7 flash_attention_kernel: {regs}; setmaxnreg honoured (no C7508), wgmma pipelined "
          f"(no C7513)" if not warned else f"phase 2 K7: {warned}", flush=True)
    if warned:
        fail("ptxas ignored K7's setmaxnreg or serialized its wgmmas")


def make_case(torch, levels, max_res, feat, hidden, out, n, gen, dev):
    from signerf_tpu_torch.ops import factor_grid as fg

    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [
        [(torch.randn(r, feat, generator=gen) * 0.2).to(dev) for _ in range(3)]
        for r in cfg.resolutions
    ]
    d = cfg.out_dim
    bf = torch.bfloat16
    ws = [
        (torch.randn(d, hidden, generator=gen) * 0.1).to(dev, bf),
        (torch.randn(hidden, generator=gen) * 0.05).to(dev, bf),
        (torch.randn(hidden, out, generator=gen) * 0.1).to(dev, bf),
        (torch.randn(out, generator=gen) * 0.05).to(dev, bf),
    ]
    x = torch.rand(n, 3, generator=gen).to(dev)
    return (cfg.resolutions, feat, fg.pack_tables(lines), *ws, x)


# The rays of K1's calls on the main paths: a render chunk, or a train
# step's 4096 (a `signerf_nerfacto` step, each of a `signerf` step's
# micro-batches).
K1_CALLS = (("chunk", CHUNK), ("train", TRAIN_RAYS))


def phase_kernel(torch) -> dict:
    """K1 against its plain twin per call, for each field at a render
    chunk's and a train step's sample counts, at three layouts of the
    samples (uniform, ray-ordered, one cell), plus N = 257 with u in {0, 1}:
    error, CUDA-event times, bounds. Returns the worst error and, per
    (field, call), the uniform layout's kernel, plain and bound times."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    worst, worst_abs, per_call = 0.0, 0.0, {}

    def check(label, args):
        nonlocal worst, worst_abs
        got = ffc.density_mlp_cuda(*args)
        torch.cuda.synchronize()
        want = ffc.density_mlp_plain(*args)
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-3)
        if not bool(torch.isfinite(got).all()) or err > KERNEL_TOL * scale:
            fail(f"K1 {label}: max abs err {err} > {KERNEL_TOL} x {scale}")
        worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
        return f"max_abs_err {err:.3g} ({err / scale:.3g} of max|ref|)"

    for name, shape, per_ray in TRAIN_SCHEDULES:
        args = list(make_case(torch, *shape, 257, gen, dev))
        args[-1][:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=dev)
        print(f"phase 3 K1 {name} N=257: " + check(f"{name} N=257", args), flush=True)
        for call, rays in K1_CALLS:
            n = rays * per_ray
            args = list(make_case(torch, *shape, n, gen, dev))
            b_ms, b_by = factor_bounds(args[0], shape[2], args[2], n, shape[3], shape[4])["K1"]
            line = [f"phase 3 K1 {name} per call at a {'render chunk' if call == 'chunk' else 'train step'}'s N={n}"
                    f" (bound {b_ms:.4f} ms, {b_by}):"]
            for layout in LAYOUTS:
                if layout == "ray-ordered":
                    args[-1] = ray_ordered_coords(torch, per_ray, gen, rays).to(dev)
                elif layout == "one cell":
                    args[-1] = one_cell_coords(torch, n, gen).to(dev)
                err = check(f"{name} N={n} {layout}", args)
                run = lambda: ffc.density_mlp_cuda(*args)  # noqa: E731
                if layout == "uniform":
                    # turns: plain, kernel, kernel, plain (compare within one call)
                    k_ms, p_ms = twin_ms(torch, run, lambda: ffc.density_mlp_plain(*args))
                    per_call[(name, call)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
                    line.append(f"{layout} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({p_ms / k_ms:.2f}x), {err};")
                else:
                    k_ms = (cuda_ms(run, 20) + cuda_ms(run, 20)) / 2
                    line.append(f"{layout} kernel {k_ms:.4f} ms, {err};")
                line[-1] = line[-1][:-1] + f", {b_ms / k_ms:.1%} of the bound;"
            print(" ".join(line), flush=True)
            del args
        if name == "final":
            # the mesh export's density calls: one a chunk of 65,536 grid points
            n = 1 << 16
            args = list(make_case(torch, *shape, n, gen, dev))
            b_ms, b_by = factor_bounds(args[0], shape[2], args[2], n, shape[3], shape[4])["K1"]
            err = check(f"{name} N={n}", args)
            k_ms, p_ms = twin_ms(torch, lambda: ffc.density_mlp_cuda(*args), lambda: ffc.density_mlp_plain(*args))
            per_call[(name, "mesh")] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            print(f"phase 3 K1 {name} per call at the mesh export's N={n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, {err}, {b_ms / k_ms:.1%} of the bound ({b_ms:.4f} ms, {b_by})", flush=True)
            del args
    torch.cuda.empty_cache()
    chunk = {k: sum(per_call[(name, "chunk")][k] for name, _, _ in TRAIN_SCHEDULES) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"phase 3 K1 per {CHUNK}-ray render chunk (its 3 calls, uniform): kernel {chunk['ms']:.4f} ms, plain "
          f"{chunk['plain_ms']:.4f} ms, bound {chunk['bound_ms']:.4f} ms; worst error {worst:.3g} of max|ref| "
          f"(bound {KERNEL_TOL})", flush=True)
    return {"max_abs_err": worst_abs, "per_call": per_call}


def per_call(label: str, calls, max_abs_err: float) -> dict:
    """A kernel's launches summed over the main path's phases, and its times
    and bound per call, each kind of call weighted by its launches there:
    `calls` is [(launches, {"ms", "plain_ms", "bound_ms", "bound_by"})], so
    that launches x (ms - bound_ms) is the time the path loses to it."""
    total = sum(w for w, _ in calls)
    out = {"launches": total, "max_abs_err": max_abs_err}
    keys = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if all("library_ms" in c for _, c in calls) else ())
    for key in keys:
        out[key] = sum(w * c[key] for w, c in calls) / max(total, 1)
    out["bound_by"] = max(calls, key=lambda wc: wc[0] * wc[1]["bound_ms"])[1]["bound_by"]
    print(f"phase 20 {label}: {total} launches; per call, weighted by launches: kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); launches x (ms - bound) "
          f"{total * (out['ms'] - out['bound_ms']):.1f} ms", flush=True)
    return out


def encode_case(torch, n, gen, dev, layout="uniform"):
    """Base-field tables, coordinates, g [N, 128] and ct [N, 3] on the card.
    Coordinates: uniform random; clustered, points along rays from a ring of
    cameras at radius 2 through the scene's centre (rays in random order);
    ray-ordered, 48 a ray laid out as a train step lays them out
    (`ray_ordered_coords`); or all in one cell (`one_cell_coords`). N = 257
    and 1003 start with rows on u = 0 and u = 1."""
    from signerf_tpu_torch.ops import factor_grid as fg
    from signerf_tpu_torch.ops.contraction import contract_to_unit

    levels, max_res, feat = BASE_SCHEDULE
    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [[torch.randn(r, feat, generator=gen) * 0.2 for _ in range(3)] for r in cfg.resolutions]
    if layout == "ray-ordered":
        x = ray_ordered_coords(torch, 48, gen, n // 48)
    elif layout == "one cell":
        x = one_cell_coords(torch, n, gen)
    elif layout == "clustered":
        rays = n // 48
        phi = torch.rand(rays, generator=gen) * 6.2832
        origin = torch.stack([2 * torch.cos(phi), 2 * torch.sin(phi), 0.7 * torch.ones(rays)], -1)
        target = torch.randn(rays, 3, generator=gen) * 0.3
        d = torch.nn.functional.normalize(target - origin, dim=-1)
        t = 1.0 + 2.0 * torch.rand(rays, 48, generator=gen).sort(-1).values
        x = contract_to_unit(origin[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    else:
        x = torch.rand(n, 3, generator=gen)
    if n in (257, 1003):
        x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]])
    g = torch.randn(n, cfg.out_dim, generator=gen)
    ct = torch.randn(n, 3, generator=gen)
    return (cfg.resolutions, feat, fg.pack_tables(lines).to(dev), x.to(dev)), g.to(dev), ct.to(dev)


def twin_ms(torch, kernel, plain, iters: int = 20):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def with_twins(ffc, names, fn):
    """fn() with the kernels `names` swapped for their plain twins."""
    kernels = {name: getattr(ffc, f"{name}_cuda") for name in names}
    for name in names:
        setattr(ffc, f"{name}_cuda", getattr(ffc, f"{name}_plain"))
    try:
        return fn()
    finally:
        for name, fn_ in kernels.items():
            setattr(ffc, f"{name}_cuda", fn_)


def phase_k3_k6(torch) -> dict:
    """K3 to K6 against their plain twins at one signerf micro-batch's
    base-field shapes and at N = 257 and 1003."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    names = ["K3", "K4 tables", "K4 coords", "K5", "K6 tables", "K6 coords"]
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in names}
    for label, n in [("uniform", SIGNERF_SAMPLES), ("clustered", SIGNERF_SAMPLES), ("boundary", 257),
                     ("boundary", 1003)]:
        args, g, ct = encode_case(torch, n, gen, dev, "uniform" if label == "boundary" else label)
        calls = {
            "K3": (lambda f: f(*args), ffc.encode_cuda, ffc.encode_plain),
            "K4": (lambda f: f(*args, g, True, True), ffc.encode_bwd_cuda, ffc.encode_bwd_plain),
            "K5": (lambda f: f(*args, g), ffc.grad_dot_cuda, ffc.grad_dot_plain),
            "K6": (lambda f: f(*args, g, ct, True, True), ffc.grad_dot_bwd_cuda, ffc.grad_dot_bwd_plain),
        }
        line = [f"phase 5 {label} N={n}:"]
        for k, (call, kern, plain) in calls.items():
            got = call(kern)
            torch.cuda.synchronize()
            want = call(plain)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            leaves = {"K4": ["K4 tables", "K4 coords"], "K6": ["K6 tables", "grad_g", "K6 coords"]}.get(k, [k])
            errs = []
            for leaf, a, b in zip(leaves, got, want):
                if not bool(torch.isfinite(a).all()):
                    fail(f"{leaf} {label} N={n}: non-finite output")
                if k == "K3":
                    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                    bound = K3_TOL
                else:
                    err, bound = rel_err(a, b), K456_TOL
                if err > bound:
                    fail(f"{leaf} {label} N={n}: error {err:.3g} > {bound}")
                errs.append(f"{leaf} {err:.2e}")
                entry = result.get(leaf, result.get("K6 tables"))
                entry["max_abs_err"] = max(entry["max_abs_err"], float((a - b).abs().max()))
                # K5 and the coords halves of K4 (K5's function) and K6 are
                # exactly 0 on an axis at a knot of every level (u = 0 or 1).
                if leaf in ("K5", "K4 coords", "K6 coords") and label == "boundary" and not (
                        bool((a[:2] == 0).all()) and float(a[2, 1]) == 0.0 and float(a[3, 1]) == 0.0
                        and (leaf == "K5" or float(a[2, 2]) == 0.0 and float(a[3, 0]) == 0.0)):
                    fail(f"{leaf} N={n}: not exactly 0 on an axis at a knot: {a[:4].tolist()}")
            line.append(", ".join(errs))
        print(" ".join(line) + (" (K5, K4 coords and K6 coords exactly 0 at the knots)" if label == "boundary"
                                else ""),
              flush=True)
        if label == "boundary":
            continue
        times = {
            "K3": (lambda: ffc.encode_cuda(*args), lambda: ffc.encode_plain(*args)),
            "K4 tables": (lambda: ffc.encode_bwd_cuda(*args, g), lambda: ffc.encode_bwd_plain(*args, g)),
            "K4 coords": (lambda: ffc.encode_bwd_cuda(*args, g, False, True),
                          lambda: ffc.encode_bwd_plain(*args, g, False, True)),
            "K5": (lambda: ffc.grad_dot_cuda(*args, g), lambda: ffc.grad_dot_plain(*args, g)),
            "K6 tables": (lambda: ffc.grad_dot_bwd_cuda(*args, g, ct), lambda: ffc.grad_dot_bwd_plain(*args, g, ct)),
            "K6 coords": (lambda: ffc.grad_dot_bwd_cuda(*args, g, ct, False, True),
                          lambda: ffc.grad_dot_bwd_plain(*args, g, ct, False, True)),
        }
        line = [f"phase 5 {label} N={n} times (kernel vs plain, ms):"]
        for k, (kern, plain) in times.items():
            k_ms, p_ms = twin_ms(torch, kern, plain)
            if label == "uniform":
                result[k]["ms"], result[k]["plain_ms"] = k_ms, p_ms
                add_bound(result[k], factor_bounds(args[0], args[1], args[2], n)[k])
            b_ms, b_by = factor_bounds(args[0], args[1], args[2], n)[k]
            line.append(f"{k} {k_ms:.4f} vs {p_ms:.4f} ({p_ms / k_ms:.2f}x, bound {b_ms:.4f} {b_by}, "
                        f"{b_ms / k_ms:.1%} of it);")
        print(" ".join(line), flush=True)
        del args, g, ct
    torch.cuda.empty_cache()
    # K3, K5 and the coords halves of K4 and K6 at the three layouts; K3 and
    # K5 at the `signerf` eval render's chunk.
    lines = {k: [f"phase 5 {k} N={SIGNERF_SAMPLES}, kernel ms at three layouts:"]
             for k in ("K3", "K5", "K4 coords", "K6 coords")}
    for layout in LAYOUTS:
        args, g, ct = encode_case(torch, SIGNERF_SAMPLES, gen, dev, layout)
        bounds = factor_bounds(args[0], args[1], args[2], SIGNERF_SAMPLES)
        got = ffc.encode_cuda(*args)
        torch.cuda.synchronize()
        want = ffc.encode_plain(*args)
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
        if err > K3_TOL or not bool(torch.isfinite(got).all()):
            fail(f"K3 {layout} N={SIGNERF_SAMPLES}: error {err:.3g} > {K3_TOL}")
        run = lambda: ffc.encode_cuda(*args)  # noqa: E731
        ms = (cuda_ms(run, 20) + cuda_ms(run, 20)) / 2
        lines["K3"].append(f"{layout} {ms:.4f} ({bounds['K3'][0] / ms:.1%} of the bound), error {err:.2e} of "
                           f"max|ref| ({int((got != want).sum())} values differ);")
        got = ffc.grad_dot_cuda(*args, g)
        torch.cuda.synchronize()
        err = rel_err(got, ffc.grad_dot_plain(*args, g))
        if err > K456_TOL or not bool(torch.isfinite(got).all()):
            fail(f"K5 {layout} N={SIGNERF_SAMPLES}: norm-relative error {err:.3g} > {K456_TOL}")
        run = lambda: ffc.grad_dot_cuda(*args, g)  # noqa: E731
        ms = (cuda_ms(run, 20) + cuda_ms(run, 20)) / 2
        lines["K5"].append(f"{layout} {ms:.4f} ({bounds['K5'][0] / ms:.1%} of the bound), norm-rel error {err:.2e};")
        for k, run, plain in (
            ("K4 coords", lambda: ffc.encode_bwd_cuda(*args, g, False, True)[1],
             lambda: ffc.encode_bwd_plain(*args, g, False, True)[1]),
            ("K6 coords", lambda: ffc.grad_dot_bwd_cuda(*args, g, ct, False, True)[2],
             lambda: ffc.grad_dot_bwd_plain(*args, g, ct, False, True)[2]),
        ):
            got = run()
            torch.cuda.synchronize()
            err = rel_err(got, plain())
            if err > K456_TOL or not bool(torch.isfinite(got).all()):
                fail(f"{k} {layout} N={SIGNERF_SAMPLES}: norm-relative error {err:.3g} > {K456_TOL}")
            ms = (cuda_ms(run, 20) + cuda_ms(run, 20)) / 2
            lines[k].append(f"{layout} {ms:.4f} ({bounds[k][0] / ms:.1%} of the bound), norm-rel error {err:.2e};")
        del args, g, ct, got, want
    for line in lines.values():
        print(" ".join(line), flush=True)
    n = CHUNK * 48
    args, g, _ = encode_case(torch, n, gen, dev)
    line = [f"phase 5 the signerf eval chunk's base field, N={n}, uniform:"]
    for k, kern, plain in (("K3", lambda: ffc.encode_cuda(*args), lambda: ffc.encode_plain(*args)),
                           ("K5", lambda: ffc.grad_dot_cuda(*args, g), lambda: ffc.grad_dot_plain(*args, g))):
        k_ms, p_ms = twin_ms(torch, kern, plain)
        b_ms, b_by = factor_bounds(args[0], args[1], args[2], n)[k]
        result[k]["eval"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
        line.append(f"{k} {k_ms:.4f} vs {p_ms:.4f} ms (bound {b_ms:.4f} {b_by});")
    print(" ".join(line), flush=True)
    del args, g
    per_step = sum(result[k]["ms"] for k in ("K3", "K4 tables", "K5", "K6 tables")) * SIGNERF_MICRO
    print(f"phase 5 K3 + K4 tables + K5 + K6 tables per {SIGNERF_RAYS}-ray signerf step "
          f"({SIGNERF_MICRO} micro-batches, uniform coordinates): {per_step:.4f} ms", flush=True)
    tables_halves_layouts(torch, ffc, gen, dev, result)
    return result


def tables_halves_layouts(torch, ffc, gen, dev, result) -> None:
    """K4's and K6's tables halves (and grad_g) at one signerf micro-batch
    in three layouts: uniform, ray-ordered (48 samples a ray in ray order,
    as a train step feeds them) and every sample in one cell. Each against
    the twin, in one cell against the twin's terms summed in float64 (there
    N f32 additions into one row stray on their own, the twin's index_add_
    as much as the kernels' reductions); the run-to-run spread of the line
    grads; times."""
    per_layout = {}
    for layout in LAYOUTS:
        n = SIGNERF_SAMPLES
        args, g, ct = encode_case(torch, n, gen, dev, layout)
        got4 = ffc.encode_bwd_cuda(*args, g)[0]
        got6, got_g, _ = ffc.grad_dot_bwd_cuda(*args, g, ct)
        torch.cuda.synchronize()
        want4 = ffc.encode_bwd_plain(*args, g)[0]
        want6, want_g, _ = ffc.grad_dot_bwd_plain(*args, g, ct)
        line = f"phase 5 tables halves {layout} N={n}:"
        ref4, ref6, against = want4, want6, "the twin"
        if layout == "one cell":
            res, feat, tables, x = args
            ref4, ref6 = f64_chunk_sum(lambda p: [ffc.encode_bwd_plain(res, feat, tables, x[p], g[p])[0],
                                                  ffc.grad_dot_bwd_plain(res, feat, tables, x[p], g[p], ct[p])[0]], n)
            against = "the twin's terms summed in float64"
            line += (f" the twin's own norm-rel err against its terms summed in float64: K4 {rel_err(want4, ref4):.2e}, "
                     f"K6 {rel_err(want6, ref6):.2e}; the kernels' against the twin: K4 {rel_err(got4, want4):.2e}, "
                     f"K6 {rel_err(got6, want6):.2e};")
        errs = []
        for leaf, a, b in (("K4 tables", got4, ref4), ("K6 tables", got6, ref6), ("grad_g", got_g, want_g)):
            if not bool(torch.isfinite(a).all()):
                fail(f"{leaf} {layout} N={n}: non-finite output")
            err = rel_err(a, b)
            if err > K456_TOL:
                fail(f"{leaf} {layout} N={n}: norm-relative error {err:.3g} against {against} > {K456_TOL}")
            errs.append(f"{leaf} {err:.2e}")
            entry = result["K6 tables"] if leaf == "grad_g" else result[leaf]
            entry["max_abs_err"] = max(entry["max_abs_err"], float((a.double() - b.double()).abs().max()))
        line += f" norm-rel err against {against} (bound {K456_TOL}): " + ", ".join(errs)
        # The same inputs twice: the vector reductions' order varies.
        d4 = float((ffc.encode_bwd_cuda(*args, g)[0] - got4).abs().max())
        d6 = float((ffc.grad_dot_bwd_cuda(*args, g, ct)[0] - got6).abs().max())
        line += (f"; run to run max |d| line grads K4 {d4:.3g} (max |lines| {float(got4.abs().max()):.3g}), "
                 f"K6 {d6:.3g} (max |lines| {float(got6.abs().max()):.3g})")
        run4 = lambda: ffc.encode_bwd_cuda(*args, g)  # noqa: E731
        run6 = lambda: ffc.grad_dot_bwd_cuda(*args, g, ct)  # noqa: E731
        ms4 = (cuda_ms(run4, 20) + cuda_ms(run4, 20)) / 2
        ms6 = (cuda_ms(run6, 20) + cuda_ms(run6, 20)) / 2
        per_layout[layout] = (ms4, ms6)
        print(line + f" | kernel ms: K4 tables {ms4:.4f}, K6 tables + grad_g {ms6:.4f}", flush=True)
        del args, g, ct, got4, got6, got_g, want4, want6, want_g, ref4, ref6
    torch.cuda.empty_cache()
    print(f"phase 5 K4 + K6 tables halves per {SIGNERF_RAYS}-ray signerf step ({SIGNERF_MICRO} micro-batches): "
          + "; ".join(f"{k} {SIGNERF_MICRO * (a + b):.4f} ms (K4 {a:.4f}, K6 {b:.4f} a call)"
                      for k, (a, b) in per_layout.items()), flush=True)


def phase_k8_k10(torch) -> dict:
    """K8, K9 and K10 against their plain twins at one signerf
    micro-batch's base-field shapes and at N = 257, the cross-checks
    against K5, K6 and K3, K9's tables half at the three layouts, and K10
    and K4 at the proposal schedule."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    names = ["K8", "K9 tables", "K9 coords", "K10"]
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in names}
    for label, n in [("uniform", SIGNERF_SAMPLES), ("clustered", SIGNERF_SAMPLES), ("boundary", 257)]:
        args, g, c = encode_case(torch, n, gen, dev, "uniform" if label == "boundary" else label)
        ct = torch.randn(n, 3, g.shape[1], generator=gen).to(dev)
        got = {"K8": ffc.grad_cuda(*args)}
        got["K9 tables"], got["K9 coords"] = ffc.grad_bwd_cuda(*args, ct, True, True)
        got["K10"] = ffc.dense_encode_cuda(*args)
        torch.cuda.synchronize()
        want = {"K8": ffc.grad_plain(*args), "K10": ffc.dense_encode_plain(*args)}
        want["K9 tables"], want["K9 coords"] = ffc.grad_bwd_plain(*args, ct, True, True)
        line = [f"phase 5b {label} N={n}:"]
        for k in names:
            a, b = got[k], want[k]
            if not bool(torch.isfinite(a).all()):
                fail(f"{k} {label} N={n}: non-finite output")
            if k == "K10":
                err, tol = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12), K3_TOL
            else:
                err, tol = rel_err(a, b), K456_TOL
            if err > tol:
                fail(f"{k} {label} N={n}: error {err:.3g} > {tol}")
            result[k]["max_abs_err"] = max(result[k]["max_abs_err"], float((a - b).abs().max()))
            line.append(f"{k} {err:.2e};")
        # Cross-checks: K8 contracted with g is K5; K9 on ct = g (x) c is K6
        # for the scalar c; K10 is K3 up to its bf16 tap weights.
        e5 = rel_err(torch.einsum("nad,nd->na", got["K8"], g), ffc.grad_dot_cuda(*args, g))
        g9, c9 = ffc.grad_bwd_cuda(*args, g[:, None, :] * c[:, :, None], True, True)
        g6, _, c6 = ffc.grad_dot_bwd_cuda(*args, g, c, True, True)
        e6t, e6c = rel_err(g9, g6), rel_err(c9, c6)
        k3 = ffc.encode_cuda(*args)
        e3 = float((got["K10"] - k3).abs().max()) / float(k3.abs().max())
        line.append(f"cross-checks: K8.g vs K5 {e5:.2e}, K9 vs K6 tables {e6t:.2e} coords {e6c:.2e} (bound "
                    f"{K456_TOL}), K10 vs K3 {e3:.2e} of max|K3| (bound {K10_K3_TOL})")
        if max(e5, e6t, e6c) > K456_TOL or e3 > K10_K3_TOL:
            fail(f"phase 5b {label}: a cross-check failed: " + line[-1])
        if n == 257 and not (bool((got["K8"][:2] == 0).all()) and bool((got["K8"][2:4, 1] == 0).all())):
            fail("K8: the slope at an exact knot is not 0")
        print(" ".join(line), flush=True)
        del got, want, g9, c9, g6, c6, k3
        if n == 257:
            continue
        times = {
            "K8": (lambda: ffc.grad_cuda(*args), lambda: ffc.grad_plain(*args)),
            "K9 tables": (lambda: ffc.grad_bwd_cuda(*args, ct), lambda: ffc.grad_bwd_plain(*args, ct)),
            "K9 coords": (lambda: ffc.grad_bwd_cuda(*args, ct, False, True),
                          lambda: ffc.grad_bwd_plain(*args, ct, False, True)),
            "K10": (lambda: ffc.dense_encode_cuda(*args), lambda: ffc.dense_encode_plain(*args)),
        }
        line = [f"phase 5b {label} N={n} times (kernel vs plain, ms):"]
        bounds = grad_bounds(args[0], args[1], args[2], n)
        for k, (kern, plain) in times.items():
            k_ms, p_ms = twin_ms(torch, kern, plain)
            if label == "uniform":
                result[k]["ms"], result[k]["plain_ms"] = k_ms, p_ms
                add_bound(result[k], bounds[k])
            b_ms, b_by = bounds[k]
            line.append(f"{k} {k_ms:.4f} vs {p_ms:.4f} ({p_ms / k_ms:.2f}x, bound {b_ms:.4f} {b_by}, "
                        f"{b_ms / k_ms:.1%} of it);")
        print(" ".join(line), flush=True)
        del args, g, c, ct
        torch.cuda.empty_cache()

    k9_tables_layouts(torch, ffc, gen, dev, result)
    # The proposal schedule (5 levels, F = 8): K10 and K4, its backward.
    for n in (257, PROPOSAL_SAMPLES):
        res, feat, tables, *_, x = make_case(torch, 5, 128, 8, 16, 1, n, gen, dev)
        if n == 257:
            x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=dev)
        g = torch.randn(n, 5 * feat, generator=gen).to(dev)
        a, b = ffc.dense_encode_cuda(res, feat, tables, x), ffc.dense_encode_plain(res, feat, tables, x)
        got4 = ffc.encode_bwd_cuda(res, feat, tables, x, g, True, True)
        torch.cuda.synchronize()
        want4 = ffc.encode_bwd_plain(res, feat, tables, x, g, True, True)
        e10 = float((a - b).abs().max()) / float(b.abs().max())
        e4 = [rel_err(u, v) for u, v in zip(got4, want4)]
        if n == 257 and not (bool((got4[1][:2] == 0).all()) and all(
                float(got4[1][r, c]) == 0.0 for r, c in ((2, 1), (2, 2), (3, 0), (3, 1)))):
            fail(f"K4 coords at the proposal schedule: not exactly 0 on an axis at a knot: {got4[1][:4].tolist()}")
        timing = ""
        if n != 257:
            k_ms, p_ms = twin_ms(torch, lambda: ffc.dense_encode_cuda(res, feat, tables, x),
                                 lambda: ffc.dense_encode_plain(res, feat, tables, x))
            b_ms, b_by = grad_bounds(res, feat, tables, n)["K10"]
            timing = (f"; K10 {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / k_ms:.1%} "
                      f"of it)")
            bounds = factor_bounds(res, feat, tables, n)
            for k, flags in (("K4 tables", (True, False)), ("K4 coords", (False, True))):
                k_ms, p_ms = twin_ms(torch, lambda: ffc.encode_bwd_cuda(res, feat, tables, x, g, *flags),
                                     lambda: ffc.encode_bwd_plain(res, feat, tables, x, g, *flags))
                b_ms, b_by = bounds[k]
                timing += (f"; {k} {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                           f"{b_ms / k_ms:.1%} of it)")
        print(f"phase 5b proposal schedule N={n}: K10 {e10:.2e} of max|ref| (bound {K3_TOL}); its backward, "
              f"K4 tables {e4[0]:.2e}, coords {e4[1]:.2e} (bound {K456_TOL})"
              f"{' (coords exactly 0 at the knots)' if n == 257 else ''}{timing}", flush=True)
        if e10 > K3_TOL or max(e4) > K456_TOL or not bool(torch.isfinite(a).all()):
            fail(f"K10 or K4 at the proposal schedule, N={n}, disagrees with its twin")
        del res, tables, x, g, a, b, got4, want4
    torch.cuda.empty_cache()
    # K4's coords half at the proposal schedule (K5's tile loop on
    # 256-sample tiles) at the three layouts: ray-ordered is 256 samples a
    # ray.
    line = f"phase 5b proposal schedule K4 coords N={PROPOSAL_SAMPLES}, kernel ms at three layouts:"
    for layout in LAYOUTS:
        res, feat, tables, *_, x = make_case(torch, 5, 128, 8, 16, 1, PROPOSAL_SAMPLES, gen, dev)
        if layout == "ray-ordered":
            x = ray_ordered_coords(torch, 256, gen, PROPOSAL_SAMPLES // 256).to(dev)
        elif layout == "one cell":
            x = one_cell_coords(torch, PROPOSAL_SAMPLES, gen).to(dev)
        g = torch.randn(PROPOSAL_SAMPLES, 5 * feat, generator=gen).to(dev)
        run = lambda: ffc.encode_bwd_cuda(res, feat, tables, x, g, False, True)[1]  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        err = rel_err(got, ffc.encode_bwd_plain(res, feat, tables, x, g, False, True)[1])
        if err > K456_TOL or not bool(torch.isfinite(got).all()):
            fail(f"K4 coords proposal {layout} N={PROPOSAL_SAMPLES}: norm-relative error {err:.3g} > {K456_TOL}")
        ms = (cuda_ms(run, 20) + cuda_ms(run, 20)) / 2
        b_ms = factor_bounds(res, feat, tables, PROPOSAL_SAMPLES)["K4 coords"][0]
        line += f" {layout} {ms:.4f} ({b_ms / ms:.1%} of the bound {b_ms:.4f}), norm-rel error {err:.2e};"
        del res, tables, x, g, got
    print(line, flush=True)
    torch.cuda.empty_cache()
    return result


def k9_tables_layouts(torch, ffc, gen, dev, result) -> None:
    """K9's tables half at one signerf micro-batch in the three layouts, as
    `tables_halves_layouts` holds K4's and K6's: against the twin, in one
    cell against the twin's terms summed in float64; the run-to-run spread
    of the line grads; times and the share of the bound."""
    n = SIGNERF_SAMPLES
    for layout in LAYOUTS:
        args, _, _ = encode_case(torch, n, gen, dev, layout)
        ct = torch.randn(n, 3, BASE_SCHEDULE[0] * BASE_SCHEDULE[2], generator=gen).to(dev)
        got = ffc.grad_bwd_cuda(*args, ct)[0]
        torch.cuda.synchronize()
        want = ffc.grad_bwd_plain(*args, ct)[0]
        line = f"phase 5b K9 tables half {layout} N={n}:"
        ref, against = want, "the twin"
        if layout == "one cell":
            res, feat, tables, x = args
            ref = f64_chunk_sum(lambda p: [ffc.grad_bwd_plain(res, feat, tables, x[p], ct[p])[0]], n)[0]
            against = "the twin's terms summed in float64"
            line += (f" the twin's own norm-rel err against its terms summed in float64 {rel_err(want, ref):.2e}, "
                     f"the kernel's against the twin {rel_err(got, want):.2e};")
        if not bool(torch.isfinite(got).all()):
            fail(f"K9 tables {layout} N={n}: non-finite output")
        err = rel_err(got, ref)
        if err > K456_TOL:
            fail(f"K9 tables {layout} N={n}: norm-relative error {err:.3g} against {against} > {K456_TOL}")
        entry = result["K9 tables"]
        entry["max_abs_err"] = max(entry["max_abs_err"], float((got.double() - ref.double()).abs().max()))
        # The same inputs twice: the vector reductions' order varies.
        d = float((ffc.grad_bwd_cuda(*args, ct)[0] - got).abs().max())
        run = lambda: ffc.grad_bwd_cuda(*args, ct)  # noqa: E731
        ms = (cuda_ms(run, 10) + cuda_ms(run, 10)) / 2
        b_ms = grad_bounds(args[0], args[1], args[2], n)["K9 tables"][0]
        print(line + f" norm-rel err against {against} {err:.2e} (bound {K456_TOL}); run to run max |d| line "
              f"grads {d:.3g} (max |lines| {float(got.abs().max()):.3g}) | kernel {ms:.4f} ms ({b_ms / ms:.1%} of "
              f"the bound {b_ms:.4f})", flush=True)
        del args, ct, got, want, ref
    torch.cuda.empty_cache()


def sphere_views(backdrop: float = 1.0):
    """The synthetic scene's views: cameras on a ring looking at a sphere of
    radius 0.6 shaded by |hit point| / 0.6, on a uniform backdrop (white:
    the analytic scene of examples/fit_synthetic.py). -> (poses [n, 4, 4],
    focal, list of images [h, w, 3] f32)."""
    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses

    n, w, h = SCENE["cameras"], SCENE["width"], SCENE["height"]
    poses = circle_poses(n, radius=2.0, theta=70.0, phi=(0.0, 360.0 * (n - 1) / n)).numpy()
    f = 0.8 * w
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d_cam = np.stack([(xx - w / 2) / f, -(yy - h / 2) / f, -np.ones_like(xx)], -1)
    views = []
    for i in range(n):
        d = d_cam @ poses[i, :3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = poses[i, :3, 3]
        b = d @ o
        disc = b * b - (o @ o - SPHERE_RADIUS**2)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit_point = o + d * t[..., None]
        img = np.where((disc > 0)[..., None], np.abs(hit_point) / SPHERE_RADIUS, backdrop)
        views.append(img.astype(np.float32))
    return poses, f, views


def write_scene(root: Path, backdrop: float = 1.0) -> Path:
    """The synthetic scene as a transforms.json dataset of PNGs."""
    from signerf_tpu_torch.utils.images import save_array_png

    w, h = SCENE["width"], SCENE["height"]
    (root / "images").mkdir(parents=True)
    poses, f, views = sphere_views(backdrop)
    frames = []
    for i, img in enumerate(views):
        save_array_png(img, root / "images" / f"frame_{i:05d}.png")
        frames.append({"file_path": f"images/frame_{i:05d}.png", "transform_matrix": poses[i].tolist()})
    meta = {"fl_x": f, "fl_y": f, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def phase_render(torch, card: str, data: Path, tmp: Path) -> int:
    """Returns K1's launch count in the CLI run."""
    import numpy as np

    from signerf_tpu_torch import render as cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.utils.images import to_uint8

    w, h, arc = SCENE["width"], SCENE["height"], SCENE["arc"]
    rays = arc * w * h
    chunks = arc * -(-(w * h) // CHUNK)
    out = tmp / "renders"
    argv = ["--data", str(data), "--output", str(out), "--arc", str(arc), "--device", "cuda", "--mesh", "none"]
    torch.cuda.synchronize()
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = ffc.launches
    if sum(counts(ffc).values()) != launches:
        fail(f"the render CLI launched other kernels than K1: {counts(ffc)}")
    if rc != 0:
        fail(f"render CLI returned {rc}")
    if launches != 3 * chunks:
        fail(f"K1 launched {launches} times in the render, expected 3 x {chunks} chunks")

    # The same model (same seed) rendered directly: warm timing, output checks.
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    dev = torch.device("cuda")
    model = cli.build_model(NerfactoModelConfig(), len(parsed.image_filenames), dev)
    cams = cli.arc_cameras(parsed.cameras.to(dev), arc, 1.0, 70.0)
    aabb = torch.as_tensor(parsed.scene_box_aabb, device=dev)
    frames = list(cli.render_cameras(model, cams, aabb))
    frame_s = []  # warm per-frame render times, host clock after a sync
    for _ in range(RENDER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _frame in cli.render_cameras(model, cams, aabb):
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    frame_s.sort()
    median_s = frame_s[len(frame_s) // 2]
    for i, f in enumerate(frames):
        for k, v in f.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"camera {i}: non-finite {k}")
        acc = f["accumulation"]
        if float(acc.min()) < 0.0 or float(acc.max()) > 1.0 + 1e-5:
            fail(f"camera {i}: accumulation outside [0, 1]")
        if tuple(f["rgb"].shape) != (h, w, 3):
            fail(f"camera {i}: rgb shape {tuple(f['rgb'].shape)}")
        png = read_png(out / f"rgb_{i:05d}.png")
        if not np.array_equal(png, to_uint8(f["rgb"].cpu().numpy())):
            fail(f"camera {i}: the CLI's rgb PNG differs from the direct render")
        if not (out / f"depth_{i:05d}.png").exists():
            fail(f"camera {i}: no depth PNG")
    acc_mean = float(torch.stack([f["accumulation"].mean() for f in frames]).mean())
    print(
        f"phase 6 render CLI: {arc} x {w}x{h} = {rays} rays in {chunks} chunks of {CHUNK}, "
        f"K1 launches {launches} (= 3 x {chunks}), CLI wall {cli_s:.3f} s "
        f"({rays / cli_s:.0f} rays/s incl. start-up and PNG writes); warm render, "
        f"median of {len(frame_s)} frames {median_s * 1e3:.3f} ms = {w * h / median_s:.0f} "
        f"rays/s (frames {frame_s[0] * 1e3:.3f} to {frame_s[-1] * 1e3:.3f} ms); "
        f"mean accumulation {acc_mean:.4f}; on {card}",
        flush=True,
    )

    # One chunk with the plain twin in place of the kernel.
    bundle = cams.generate_rays(camera_index=0, aabb=aabb).reshape((h * w,))
    chunk = bundle.map(lambda x: x[:CHUNK])
    render = make_eval_render(model, chunk_size=CHUNK)
    kern = render(chunk)
    launch_kernel = ffc.density_mlp_cuda
    ffc.density_mlp_cuda = ffc.density_mlp_plain
    try:
        plain = render(chunk)
    finally:
        ffc.density_mlp_cuda = launch_kernel
    d_rgb = float((kern["rgb"] - plain["rgb"]).abs().max())
    d_acc = float((kern["accumulation"] - plain["accumulation"]).abs().max())
    print(
        f"phase 6 one chunk, kernel vs plain twin: max |d rgb| {d_rgb:.3g}, "
        f"max |d accumulation| {d_acc:.3g} (tolerance {CHUNK_TOL})"
    )
    if d_rgb > CHUNK_TOL or d_acc > CHUNK_TOL:
        fail("kernel and plain renders of one chunk disagree")
    return launches


def rel_err(a, b) -> float:
    """Norm-relative error of a against b."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-12))


def ray_ordered_coords(torch, per_ray: int, gen, rays: int):
    """[rays x per_ray, 3] sample positions in [0, 1]^3 laid out as a train
    step lays them out: ray by ray, each ray's samples in order along it.
    Rays of the smoke scene's cameras through random pixels; distances from
    0.05 to 1000, stratified, the first half linear to 1 and the second
    linear in disparity (the proposal sampler's spacing); contracted into
    the unit cube as the fields see them."""
    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.ops.contraction import contract_to_unit

    n_cam, w, h = SCENE["cameras"], SCENE["width"], SCENE["height"]
    poses = circle_poses(n_cam, radius=2.0, theta=70.0, phi=(0.0, 360.0 * (n_cam - 1) / n_cam))
    f = 0.8 * w
    cam = torch.randint(0, n_cam, (rays,), generator=gen)
    px = torch.rand(rays, 2, generator=gen) * torch.tensor([float(w), float(h)])
    d_cam = torch.stack([(px[:, 0] - w / 2) / f, -(px[:, 1] - h / 2) / f, -torch.ones(rays)], -1)
    d = torch.nn.functional.normalize(torch.einsum("rij,rj->ri", poses[cam, :3, :3], d_cam), dim=-1)
    s = (torch.arange(per_ray) + torch.rand(rays, per_ray, generator=gen)) / per_ray
    near, far = 0.05, 1000.0
    t = torch.where(s < 0.5, near + (1.0 - near) * 2 * s, 1.0 / (1.0 - (2 * s - 1) * (1.0 - 1.0 / far)))
    return contract_to_unit(poses[cam, None, :3, 3] + d[:, None] * t[..., None]).reshape(-1, 3)


def one_cell_coords(torch, n: int, gen, width: float = 1e-4):
    """n points inside one cell of every level of every train schedule: the
    worst case of the line-grad scatter (every sample adds into the same
    two rows of each level and axis)."""
    import math

    from signerf_tpu_torch.ops import factor_grid as fg

    res = sorted({r for _, (levels, max_res, feat, _, _), _ in TRAIN_SCHEDULES for r in fg.FactorGridConfig(
        num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat).resolutions})
    for k in range(1000):
        c = 0.3 + 1e-3 * k
        if all(math.floor(c * (r - 1)) == math.floor((c + width) * (r - 1)) and c * (r - 1) % 1 > 1e-3
               for r in res):
            return c + width * torch.rand(n, 3, generator=gen)
    raise RuntimeError("no point lies inside one cell of every level")


LAYOUTS = ("uniform", "ray-ordered", "one cell")


def f64_chunk_sum(twin, n: int, chunk: int = 2048) -> list:
    """A plain twin's sums over samples in float64: `twin(part)` gives a
    list of tensors for the samples in slice `part`; it runs on chunks of
    `chunk` samples (so its f32 sums hold at most `chunk` terms) and the
    chunks' results are added in float64."""
    total = None
    for s in range(0, n, chunk):
        part = [t.double() for t in twin(slice(s, s + chunk))]
        total = part if total is None else [a + b for a, b in zip(total, part)]
    return total


def phase_k2(torch) -> dict:
    """K2, both halves, against its plain twin at one train step's shapes:
    uniform random coordinates, ray-ordered ones and every sample in one
    cell, plus N = 257 with rows on u in {0, 1}; times of both halves at the
    three layouts (the coords half with its share of the bound), each
    schedule's share of the step, and the tables half's run-to-run spread."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    worst_rel = worst_abs = 0.0
    step = {"tables": 0.0, "tables_plain": 0.0, "coords": 0.0, "coords_plain": 0.0}
    per_layout = {layout: {} for layout in LAYOUTS}
    coords_layout = {layout: {} for layout in LAYOUTS}  # (ms, bound ms) a field
    worst_coords = 0.0
    spread = {"line grads": 0.0, "dW0": 0.0}
    occupancy, per_call = [], {}
    names = ["line grads", "dW0", "db0", "dW1", "db1", "coords"]
    for name, shape, per_ray in TRAIN_SCHEDULES:
        _, _, _, hidden, out = shape
        n = TRAIN_RAYS * per_ray
        res, feat, tables, w0, b0, w1, _, x_uniform = make_case(torch, *shape, n, gen, dev)
        smem, blocks = ffc.density_mlp_bwd_occupancy(res, feat, hidden, out)
        smem_c, blocks_c = ffc.density_mlp_bwd_occupancy(res, feat, hidden, out, tables_half=False)
        occupancy.append(f"{name} {smem} B x {blocks} blocks ({4 * blocks} warps) an SM, the coords kernel's "
                         f"{smem_c} B x {blocks_c} blocks ({feat // 2 * blocks_c} warps)")
        g = torch.randn(n, out, generator=gen).to(dev)
        layouts = [("boundary", None), ("uniform", x_uniform),
                   ("ray-ordered", ray_ordered_coords(torch, per_ray, gen, TRAIN_RAYS).to(dev)),
                   ("one cell", one_cell_coords(torch, n, gen).to(dev))]
        for layout, x in layouts:
            if x is None:  # N = 257, rows on the unit cube's faces
                x = torch.rand(257, 3, generator=gen).to(dev)
                x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=dev)
            args = (res, feat, tables, w0, b0, w1, x, g[: x.shape[0]].contiguous())
            got = ffc.density_mlp_bwd_cuda(*args, tables_half=True, coords_half=True)
            torch.cuda.synchronize()
            want = ffc.density_mlp_bwd_plain(*args, tables_half=True, coords_half=True)
            ref, against = want, "twin"
            if layout == "one cell":
                # Every sample adds into the same two rows of each level and
                # axis, where N f32 atomics stray on their own (the twin's
                # index_add_ too): the gate takes the twin's terms summed in
                # float64, and the twin's own error against them is shown.
                def twin(p):
                    lines, ws, _ = ffc.density_mlp_bwd_plain(res, feat, tables, w0, b0, w1, x[p], g[p])
                    return [lines, *ws]

                lines, *ws = f64_chunk_sum(twin, x.shape[0])
                # du is per sample: against the twin itself.
                ref, against = (lines, tuple(ws), want[2]), "the twin's terms summed in float64 (coords: the twin)"
                drift = " ".join(f"{rel_err(a, b):.2e}" for a, b in zip([want[0], *want[1]], [ref[0], *ref[1]]))
                print(f"phase 4 K2 {name} one cell N={x.shape[0]}: the twin's own norm-rel err against its terms "
                      f"summed in float64 (lines, dW0, db0, dW1, db1) {drift}; the kernel's against the twin "
                      + " ".join(f"{rel_err(a, b):.2e}" for a, b in zip([got[0], *got[1]], [want[0], *want[1]])),
                      flush=True)
            errs = []
            for leaf, a, b in zip(names, [got[0], *got[1], got[2]], [ref[0], *ref[1], ref[2]]):
                if not bool(torch.isfinite(a).all()):
                    fail(f"K2 {name} {layout} N={x.shape[0]}: non-finite {leaf}")
                r, e = rel_err(a, b), float((a - b).abs().max())
                if r > K2_TOL:
                    fail(f"K2 {name} {layout} N={x.shape[0]}: {leaf} norm-relative error {r:.3g} > {K2_TOL}")
                errs.append(f"{r:.2e}")
                worst_rel, worst_abs = max(worst_rel, r), max(worst_abs, e)
                if leaf == "coords":
                    worst_coords = max(worst_coords, r)
            line = (f"phase 4 K2 {name} {layout} N={x.shape[0]}: norm-rel err against {against} (lines, dW0, db0, "
                    "dW1, db1, coords) " + " ".join(errs))
            if layout != "boundary":
                # The same inputs twice: the vector reductions' order varies.
                again = ffc.density_mlp_bwd_cuda(*args)
                d_lines = float((again[0] - got[0]).abs().max())
                d_w0 = float((again[1][0] - got[1][0]).abs().max())
                spread["line grads"] = max(spread["line grads"], d_lines)
                spread["dW0"] = max(spread["dW0"], d_w0)
                line += (f"; run to run max |d| lines {d_lines:.3g} (max |lines| {float(got[0].abs().max()):.3g}), "
                         f"dW0 {d_w0:.3g} (max |dW0| {float(got[1][0].abs().max()):.3g})")
                run_tables = lambda: ffc.density_mlp_bwd_cuda(*args)  # noqa: E731
                run_coords = lambda: ffc.density_mlp_bwd_cuda(*args, tables_half=False, coords_half=True)  # noqa: E731
                b = factor_bounds(res, feat, tables, n, hidden, out)
                if layout == "uniform":
                    # turns: plain, kernel, kernel, plain (compare within one call)
                    t_ms, tp_ms = twin_ms(torch, run_tables, lambda: ffc.density_mlp_bwd_plain(*args))
                    c_ms, cp_ms = twin_ms(torch, run_coords, lambda: ffc.density_mlp_bwd_plain(
                        *args, tables_half=False, coords_half=True))
                    step["tables"] += t_ms
                    step["tables_plain"] += tp_ms
                    step["coords"] += c_ms
                    step["coords_plain"] += cp_ms
                    add_bound(step, b["K2 tables"], "_tables")
                    add_bound(step, b["K2 coords"], "_coords")
                    per_call[name] = {
                        "tables": {"ms": t_ms, "plain_ms": tp_ms, "bound_ms": b["K2 tables"][0],
                                   "bound_by": b["K2 tables"][1]},
                        "coords": {"ms": c_ms, "plain_ms": cp_ms, "bound_ms": b["K2 coords"][0],
                                   "bound_by": b["K2 coords"][1]},
                    }
                    line += (f" | tables half: kernel {t_ms:.4f} ms, plain {tp_ms:.4f} ms; "
                             f"coords half: kernel {c_ms:.4f} ms, plain {cp_ms:.4f} ms")
                else:
                    t_ms = (cuda_ms(run_tables, 20) + cuda_ms(run_tables, 20)) / 2
                    c_ms = (cuda_ms(run_coords, 20) + cuda_ms(run_coords, 20)) / 2
                    line += f" | tables half: kernel {t_ms:.4f} ms; coords half: kernel {c_ms:.4f} ms"
                line += f" ({b['K2 coords'][0] / c_ms:.1%} of its bound, {b['K2 coords'][0]:.4f} ms)"
                per_layout[layout][name] = t_ms
                coords_layout[layout][name] = (c_ms, b["K2 coords"][0])
            print(line, flush=True)
            del args, got, want, ref
        del tables, x_uniform, g, layouts
    torch.cuda.empty_cache()
    shares = "; ".join(
        f"{layout} {sum(v.values()):.4f} ms (" + ", ".join(f"{k} {t / sum(v.values()):.1%}" for k, t in v.items()) + ")"
        for layout, v in per_layout.items()
    )
    coords_shares = "; ".join(
        f"{layout} " + ", ".join(f"{k} {ms:.4f} ms ({bd / ms:.1%})" for k, (ms, bd) in v.items())
        + f", the 3 calls {sum(ms for ms, _ in v.values()):.4f} ms" for layout, v in coords_layout.items()
    )
    print(f"phase 4 K2 coords half per call (share of its bound): {coords_shares}; worst norm-rel err against the "
          f"twin {worst_coords:.3g} (bound {K2_TOL})", flush=True)
    print(
        f"phase 4 K2 per {TRAIN_RAYS}-ray train step (its 3 calls): tables half kernel {shares}; plain "
        f"{step['tables_plain']:.4f} ms (uniform); coords half kernel {step['coords']:.4f} ms vs plain "
        f"{step['coords_plain']:.4f} ms; bounds {step['bound_ms_tables']:.4f} ms ({step['bound_by_tables']}) and "
        f"{step['bound_ms_coords']:.4f} ms ({step['bound_by_coords']}); worst norm-rel {worst_rel:.3g} (bound "
        f"{K2_TOL}), worst max abs {worst_abs:.3g}; tables half run to run, max |d| line grads "
        f"{spread['line grads']:.3g}, dW0 {spread['dW0']:.3g}; dynamic shared memory and residency: "
        + "; ".join(occupancy),
        flush=True,
    )
    return {"max_abs_err": worst_abs, "per_call": per_call}


def train_argv(method: str, data: Path, out: Path, steps: int, *extra: str, mesh: str = "none"):
    return [
        method, "--data", str(data), "--train-only", "True", "--device", "cuda", "--mesh", mesh,
        "--max-num-iterations", str(steps), "--steps-per-save", str(steps),
        "--output-dir", str(out), *extra,
    ]


# ffc's launch counters (fused_factor_cuda.COUNTERS order), as the JSON
# line and the printed lines name them.
KERNEL_NAMES = ("K1", "K2 tables", "K2 coords", "K3", "K4 tables", "K4 coords", "K5", "K6 tables", "K6 coords",
                "K8", "K9 tables", "K9 coords", "K10")


def zero_counts(ffc) -> None:
    for name in ffc.COUNTERS:
        setattr(ffc, name, 0)


def counts(ffc) -> dict:
    return {k: getattr(ffc, name) for k, name in zip(KERNEL_NAMES, ffc.COUNTERS)}


def expect_counts(**per_step):
    """The launch counts a run must show, every kernel not named at 0."""
    return lambda steps: {k: per_step.get(k.replace(" ", "_"), 0) * steps for k in KERNEL_NAMES}


NERFACTO_COUNTS = expect_counts(K1=3, K2_tables=3)
SIGNERF_COUNTS = expect_counts(K1=8, K2_tables=8, K3=4, K4_tables=4, K5=4, K6_tables=4)


def phase_train(torch, card: str, data: Path, tmp: Path, method: str, steps: int, rays: int,
                micro: int, expected, phase, extra=(), label=None) -> dict:
    """The train CLI at full width (with `extra` flags, output under
    tmp / (label or method)); per-micro-batch losses and CUDA events are
    recorded through the train step's loss function (no host sync)."""
    import warnings

    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    losses, events = [], []
    real_loss = tts.default_loss_fn

    def recording_loss(model, outputs, batch):
        total, ld = real_loss(model, outputs, batch)
        losses.append(total.detach())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return total, ld

    out = tmp / (label or method)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tts.default_loss_fn = recording_loss
    zero_counts(ffc)
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc = cli.main(train_argv(method, data, out, steps, *extra))
    finally:
        tts.default_loss_fn = real_loss
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(ffc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        fail(f"{method} train CLI returned {rc}")
    if got != expected(steps):
        fail(f"{method} train launches {got}; expected {expected(steps)}")
    uncalibrated = any("RANDOM-INIT" in str(w.message) for w in caught)
    if method == "signerf" and not uncalibrated:
        fail("the signerf train CLI ran random LPIPS weights without the uncalibrated warning")
    loss = torch.stack(losses).float().cpu()
    if len(loss) != steps * micro or not bool(torch.isfinite(loss).all()):
        fail(f"{len(loss)} losses recorded for {steps} x {micro} micro-batches, finite: "
             f"{bool(torch.isfinite(loss).all())}")
    loss = loss.view(steps, micro).mean(1)
    first, last = float(loss[:20].mean()), float(loss[-20:].mean())
    if not last < first:
        fail(f"{method}: loss did not fall: first 20 steps {first:.5f}, last 20 {last:.5f}")
    ends = events[micro - 1 :: micro]  # each step's last micro-batch loss
    step_ms = sorted(ends[i - 1].elapsed_time(ends[i]) for i in range(11, len(ends)))
    median = step_ms[len(step_ms) // 2]
    ckpts = sorted((out / "experiment" / method / "checkpoints").glob("step-*.pt"))
    if not ckpts or ckpts[-1].name != f"step-{steps:09d}.pt":
        fail(f"no step-{steps:09d}.pt written: {[c.name for c in ckpts]}")
    launched = ", ".join(f"{k} {v}" for k, v in got.items() if v)
    print(
        f"phase {phase} train CLI: {' '.join((method, *extra))}, {steps} steps of {rays} rays ({micro} micro-batches) at "
        f"full width, loss {float(loss[0]):.5f} -> {float(loss[-1]):.5f} (mean of first 20 {first:.5f}, "
        f"last 20 {last:.5f}); launches {launched}, all others 0; uncalibrated-LPIPS warning "
        f"{'printed' if uncalibrated else 'none'}; warm step median {median:.3f} ms over {len(step_ms)} "
        f"steps (range {step_ms[0]:.3f} to {step_ms[-1]:.3f} ms) = {rays / median * 1e3:.0f} train rays/s; "
        f"CLI wall {wall:.3f} s; peak memory {peak:.3f} GiB; on {card}",
        flush=True,
    )
    return {"launches": got, "ckpt_dir": ckpts[-1].parent, "rays_per_s": rays / median * 1e3}


def phase_camera_opt(torch, data: Path, tmp: Path, method: str, steps: int, expected, phase: int) -> dict:
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    torch.cuda.synchronize()
    zero_counts(ffc)
    rc = cli.main(train_argv(method, data, tmp / f"{method}_camopt", steps, "--steps-per-call", "1",
                             "--pipeline.model.use-camera-opt", "True"))
    torch.cuda.synchronize()
    got = counts(ffc)
    if rc != 0 or got != expected(steps):
        fail(f"{method} camera-opt train: rc {rc}, launches {got}, expected {expected(steps)}")
    launched = ", ".join(f"{k} {v}" for k, v in got.items() if v)
    print(f"phase {phase} train CLI ({method}) with camera opt, {steps} steps: launches {launched}",
          flush=True)
    return got


def phase_plain_step(torch, data: Path) -> None:
    """One step's gradients, kernels vs both plain twins, same params and pixels."""
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.data.pixel_samplers import sample_pixels
    from signerf_tpu_torch.engine.train_step import default_loss_fn
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    cams = parse_transforms(SIGNeRFDataParserConfig(data=data)).cameras.to(dev)
    model = NerfactoModel(NerfactoModelConfig(), len(cams))
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    idx = sample_pixels(torch.Generator(device=dev).manual_seed(0), TRAIN_RAYS, len(cams), cams.height, cams.width)
    target = torch.rand(TRAIN_RAYS, 3, generator=torch.Generator().manual_seed(0)).to(dev)

    def grads():
        model.zero_grad()
        out = model(cams.generate_rays_at(idx), None, train=True, anneal=1.0)
        total, _ = default_loss_fn(model, out, {"image": target})
        total.backward()
        return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, gk = grads()
    fwd, bwd = ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda
    ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda = ffc.density_mlp_plain, ffc.density_mlp_bwd_plain
    try:
        loss_p, gp = grads()
    finally:
        ffc.density_mlp_cuda, ffc.density_mlp_bwd_cuda = fwd, bwd
    errs = {n: rel_err(gk[n], gp[n]) for n in gk}
    worst = max(errs, key=errs.get)
    print(
        f"phase 9 one train step, kernels vs plain twins: loss {loss_k:.6f} vs {loss_p:.6f}; worst "
        f"per-leaf norm-relative grad difference {errs[worst]:.3g} ({worst}), median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g} (bound {STEP_TOL})",
        flush=True,
    )
    if errs[worst] > STEP_TOL or not abs(loss_k - loss_p) <= 1e-3 * abs(loss_p):
        fail("kernel and plain-twin train steps disagree")


def phase_eval(torch, data: Path, tmp: Path, ckpt_dir: Path) -> float:
    """The trained checkpoint: its train-view PSNR (camera 0 rendered as the
    train step casts rays, with its own appearance code), then the render
    and eval CLIs (restore surgery; the eval CLI clips rays to the scene
    box, as the JAX CLI does)."""
    import json as _json

    from signerf_tpu_torch import eval as eval_cli
    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops.image_metrics import psnr as psnr_fn
    from signerf_tpu_torch.utils.images import load_rgb

    dev = torch.device("cuda")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    cams = parsed.cameras.to(dev)
    model = NerfactoModel(NerfactoModelConfig(), len(cams))
    model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
    model = model.to(dev).eval()
    h, w = cams.height, cams.width
    out = make_eval_render(model, chunk_size=CHUNK)(
        cams.generate_rays(camera_index=0).reshape((h * w,)), appearance_mode="index"
    )
    gt = torch.from_numpy(load_rgb(parsed.image_filenames[0])).to(dev).float() / 255.0
    train_view = float(psnr_fn(out["rgb"].reshape(h, w, 3), gt))

    render_out = tmp / "trained_render"
    if render_cli.main(["--data", str(data), "--output", str(render_out), "--load-dir", str(ckpt_dir),
                        "--arc", "1", "--device", "cuda", "--mesh", "none", "--depth", "false"]) != 0:
        fail("render CLI could not render the trained checkpoint")
    if not (render_out / "rgb_00000.png").exists():
        fail("render CLI wrote no PNG for the trained checkpoint")
    psnr = {}
    for name, load in [("trained", ["--load-dir", str(ckpt_dir)]), ("init", [])]:
        path = tmp / f"eval_{name}.json"
        if eval_cli.main(["--data", str(data), "--output", str(path), "--device", "cuda", "--mesh", "none",
                          *load]) != 0:
            fail(f"eval CLI failed ({name})")
        psnr[name] = _json.loads(path.read_text())["psnr"]
    print(f"phase 10 trained checkpoint: train-view PSNR (camera 0) {train_view:.3f} dB; render CLI "
          f"wrote it; eval CLI PSNR over {SCENE['cameras']} cameras {psnr['trained']:.3f} dB (seeded "
          f"init {psnr['init']:.3f} dB, gain required {EVAL_GAIN_DB} dB)", flush=True)
    if not psnr["trained"] >= psnr["init"] + EVAL_GAIN_DB or train_view != train_view:
        fail("training did not raise the eval CLI's PSNR enough, or the train view is NaN")
    return psnr["trained"]


SIX = ("density_mlp", "density_mlp_bwd", "encode", "encode_bwd", "grad_dot", "grad_dot_bwd")


def signerf_setup(torch, data: Path, ckpt_dir: Path, use_lpips: bool = True):
    """The `signerf` method's datamanager and its trained model on the card."""
    import dataclasses

    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.models.signerf import SIGNeRFModel

    dev = torch.device("cuda")
    pipe = signerf_method().pipeline
    dm = SIGNeRFDataManager(dataclasses.replace(pipe.datamanager, dataparser=dataclasses.replace(
        pipe.datamanager.dataparser, data=data)), dev)
    model = SIGNeRFModel(dataclasses.replace(pipe.model, use_lpips=use_lpips), dm.num_images)
    model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
    return dm, model.to(dev)


def phase_signerf_step(torch, data: Path, ckpt_dir: Path) -> None:
    """One signerf micro-batch (4 patches of 32x32) of the trained model:
    gradients with the six kernels vs the six plain twins, finite normals,
    and the orientation loss's own gradient in the line tables."""
    from signerf_tpu_torch.data.pixel_samplers import gather_pixels
    from signerf_tpu_torch.engine.train_step import default_loss_fn
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    dm, model = signerf_setup(torch, data, ckpt_dir)
    cams = dm.cameras
    rays = SIGNERF_RAYS // SIGNERF_MICRO
    # Four 32x32 patches on the sphere (its image is ~260 px across) and
    # across its silhouette, not on the white background.
    corners = torch.tensor([[0, 240, 240], [1, 240, 112], [2, 112, 240], [3, 360, 360]])
    dy, dx = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    offsets = torch.stack([torch.zeros_like(dy), dy, dx], -1).view(1, -1, 3)
    idx = (corners[:, None] + offsets).view(-1, 3).int().to(dev)
    rb = cams.generate_rays_at(idx)
    batch = {"image": gather_pixels(dm.images, idx).float() / 255.0}

    def grads():
        model.zero_grad()
        out = model(rb, None, train=True, anneal=1.0)
        total, _ = default_loss_fn(model, out, batch)
        total.backward()
        g = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
        return float(total.detach()), g, out

    loss_k, gk, out = grads()
    for key in ("normals_samples", "pred_normals_samples", "normals", "pred_normals"):
        if not bool(torch.isfinite(out[key]).all()):
            fail(f"signerf step: non-finite {key}")
    kernels = {name: getattr(ffc, f"{name}_cuda") for name in SIX}
    for name in SIX:
        setattr(ffc, f"{name}_cuda", getattr(ffc, f"{name}_plain"))
    try:
        loss_p, gp, _ = grads()
    finally:
        for name, fn in kernels.items():
            setattr(ffc, f"{name}_cuda", fn)
    errs = {n: rel_err(gk[n], gp[n]) for n in gk}
    worst = max(errs, key=errs.get)

    model.zero_grad()
    out = model(rb, None, train=True, anneal=1.0)
    model.normals_losses(out)["orientation_loss"].backward()
    line_grads = [p.grad for n, p in model.field.encoding.named_parameters()]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in line_grads):
        fail("signerf step: the orientation loss gives missing or non-finite line-table gradients")
    orient_norm = float(torch.stack([g.norm() for g in line_grads]).norm())
    print(
        f"phase 13 one signerf micro-batch ({rays} rays), six kernels vs six plain twins: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; worst per-leaf norm-relative grad difference {errs[worst]:.3g} "
        f"({worst}), median {sorted(errs.values())[len(errs) // 2]:.3g} (bound {STEP_TOL}); normals "
        f"finite; orientation-loss gradient in the line tables, norm {orient_norm:.4g}",
        flush=True,
    )
    if errs[worst] > STEP_TOL or not abs(loss_k - loss_p) <= 1e-3 * abs(loss_p):
        fail("kernel and plain-twin signerf steps disagree")
    if not orient_norm > 0:
        fail("the orientation loss does not reach the line tables")


def phase_profile(torch, card: str, data: Path, ckpt_dir: Path) -> None:
    """Warm signerf train steps under torch.profiler: device time per step by
    kernel, the device's busy share of the steps' span, and LPIPS (forward
    and backward over one step's 16 patches) timed alone."""
    from signerf_tpu_torch.engine.optimizers import make_optimizer
    from signerf_tpu_torch.engine.train_step import make_train_step
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.ops.lpips import lpips

    dev = torch.device("cuda")
    dm, model = signerf_setup(torch, data, ckpt_dir)
    step = make_train_step(model, make_optimizer(signerf_method().optimizers, model), dm.cameras,
                           dm.sampler_settings())
    gen = torch.Generator(device=dev).manual_seed(3)
    index = itertools.count()
    bd = kernel_breakdown(lambda: step(next(index), dm.images, dm.mask_indices, gen), TRAIN_KERNEL_GROUPS,
                          iters=PROFILE_STEPS, warmup=2)
    groups = bd["groups_ms"]
    other = groups.pop("other")
    span_ms, busy = bd["span_ms"], bd["busy_ms"]
    x = (torch.rand(16, 32, 32, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1).to(dev)
    y = (torch.rand(16, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1).to(dev)

    def lpips_step():
        xx = x.clone().requires_grad_(True)
        lpips(model.lpips_params, xx, y).mean().backward()

    lpips_ms = cuda_ms(lpips_step, 10)
    parts = "; ".join(f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in groups.items())
    print(
        f"phase 13 profile, {PROFILE_STEPS} warm signerf steps of {SIGNERF_RAYS} rays: span "
        f"{span_ms:.3f} ms a step, device busy {busy:.3f} ms ({bd['busy_share']:.1%}, idle "
        f"{bd['idle_share']:.1%}); {parts}; other kernels {other:.3f} ms ({other / busy:.1%}); K4 "
        f"{groups['K4'] / SIGNERF_MICRO:.3f} and K6 {groups['K6'] / SIGNERF_MICRO:.3f} ms a call ({SIGNERF_MICRO} "
        f"a step); LPIPS forward + backward over 16 patches alone {lpips_ms:.3f} ms; on {card}",
        flush=True,
    )


def phase_signerf_eval(torch, data: Path, ckpt_dir: Path) -> dict:
    """One full-frame render of the trained signerf model (normals on) through
    make_eval_render: K3 and K5 once per chunk, K1 twice."""
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dm, model = signerf_setup(torch, data, ckpt_dir, use_lpips=False)
    cams = dm.cameras
    h, w = cams.height, cams.width
    chunks = -(-(h * w) // CHUNK)
    bundle = cams.generate_rays(camera_index=0).reshape((h * w,))
    render = make_eval_render(model.eval(), chunk_size=CHUNK)
    torch.cuda.synchronize()
    zero_counts(ffc)
    t0 = time.perf_counter()
    out = render(bundle, appearance_mode="index")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts(ffc)
    want = expect_counts(K1=2, K3=1, K5=1)(chunks)
    if got != want:
        fail(f"signerf eval render launches {got}, expected {want}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"signerf eval render: non-finite {k}")
    acc = out["accumulation"]
    print(f"phase 14 signerf eval render, {w}x{h} in {chunks} chunks of {CHUNK}: launches K1 {got['K1']}, "
          f"K3 {got['K3']}, K5 {got['K5']}, all others 0; outputs finite, accumulation "
          f"{float(acc.min()):.4f} to {float(acc.max()):.4f}; {secs:.3f} s ({h * w / secs:.0f} rays/s, "
          f"the first frame)", flush=True)
    return got


# The entry points of K8 to K10 and the plain functions their kernels
# replace (`fused_factor_cuda.<name>_cuda` -> `<name>_plain`).
GRAD_ENTRY_KERNELS = ("grad", "grad_bwd", "dense_encode", "encode_bwd")
GRAD_ENTRY_COUNTS = expect_counts(K8=2, K9_tables=1, K9_coords=1, K10=1, K4_tables=1, K4_coords=1)


def phase_grad_entry_points(torch, card: str, data: Path, ckpt_dir: Path) -> dict:
    """K8, K9 and K10 through their entry points on the trained signerf base
    field's line tables, at one micro-batch of clustered coordinates; then
    the same calls on the plain twins."""
    from signerf_tpu_torch.ops import factor_grid as fg
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.ops.factor_grid_kernel import factor_encode_kernel

    dev = torch.device("cuda")
    _, model = signerf_setup(torch, data, ckpt_dir, use_lpips=False)
    enc = model.field.encoding
    cfg, lines = enc.config, enc.get_lines()
    flat = [t for axes in lines for t in axes]
    gen = torch.Generator().manual_seed(11)
    (_, _, _, x), _, _ = encode_case(torch, SIGNERF_SAMPLES, gen, dev, "clustered")
    n, d = x.shape[0], cfg.out_dim
    ct = torch.randn(n, 3, d, generator=gen).to(dev)
    g = torch.randn(n, d, generator=gen).to(dev)

    def run():
        enc.zero_grad()
        xx = x.clone().requires_grad_(True)
        dfeat = fg.grad_encode_fused(cfg, lines, xx)
        (dfeat * ct).sum().backward()
        out = {"grad_encode_fused": dfeat.detach(), "grad_encode_fused x01 grad": xx.grad,
               "grad_encode_fused line grads": torch.cat([t.grad.reshape(-1) for t in flat])}
        enc.zero_grad()
        out["fused_factor_grad"] = fg.fused_factor_grad(cfg, lines, x).detach()
        xx = x.clone().requires_grad_(True)
        feat = factor_encode_kernel(xx, flat, cfg.resolutions)
        (feat * g).sum().backward()
        out.update({"factor_encode_kernel": feat.detach(), "factor_encode_kernel x01 grad": xx.grad,
                    "factor_encode_kernel line grads": torch.cat([t.grad.reshape(-1) for t in flat])})
        return out

    torch.cuda.synchronize()
    zero_counts(ffc)
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts(ffc)
    if launched != GRAD_ENTRY_COUNTS(1):
        fail(f"the entry points of K8 to K10 launched {launched}, expected {GRAD_ENTRY_COUNTS(1)}")
    want = with_twins(ffc, GRAD_ENTRY_KERNELS, run)
    errs = []
    for k, a in got.items():
        b = want[k]
        if not bool(torch.isfinite(a).all()):
            fail(f"phase 14b: non-finite {k}")
        if k == "factor_encode_kernel":
            err, tol = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12), K3_TOL
        else:
            err, tol = rel_err(a, b), K456_TOL
        if err > tol:
            fail(f"phase 14b: {k} through the kernels vs the twins: {err:.3g} > {tol}")
        errs.append(f"{k} {err:.2e}")
    if not torch.equal(got["fused_factor_grad"], got["grad_encode_fused"]):
        fail("phase 14b: fused_factor_grad and grad_encode_fused differ in the forward")
    print(f"phase 14b entry points of K8 to K10 on the trained signerf base field ({n} clustered samples): "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launched.items() if v) + f", all others 0, "
          f"{secs:.3f} s; kernels vs twins: " + ", ".join(errs) + f"; on {card}", flush=True)
    return launched


# The reference sheet's NeRF. On the white scene of phases 7 to 14 the
# NeRF learns no geometry: it soon renders white everywhere (its colour
# head saturated, accumulation ~0; phase 10's PSNR is that of an all-white
# image), so its median depth never meets a selection box; phase 14c
# measures this on phase 7's checkpoint every run. The same scene on a
# mid-grey backdrop, trained by the same CLI with the white background
# colour, has to explain the backdrop with density and learns the sphere
# with it. That scene and config make the reference sheet's NeRF.
REFERENCE_BACKDROP = 0.5
REFERENCE_FLAGS = ("--pipeline.model.background-color", "white")
# The selection: an AABB around the top cap of the sphere and the bunny
# proxy sitting on it, both given in the scene's own frame (the sphere of
# radius 0.6 at its origin) and carried into the NeRF's world frame by the
# dataparser's transform and scale.
SHEET_AABB_SCENE = ((-0.35, -0.35, 0.25), (0.35, 0.35, 0.75))
BUNNY_SCENE = dict(position=(0.0, 0.0, 0.5), rotation=(90.0, 0.0, 0.0), scale=0.035)
MASK_DILATION = (50, 50)  # the generator's default
# The reference NeRF's schedules: 300 steps (phase 7's), then, while a
# reference mask is empty, a fresh NeRF of 600 and of 900 steps. At 300
# steps the runs part at f32 rounding (PERF.md section 6): 23.7 to 33.8
# dB, and in one run of three 4 of the 8 masks empty. The check that
# every cell has a mask stays on the last NeRF trained.
REFERENCE_STEPS = (TRAIN_STEPS, 2 * TRAIN_STEPS, 3 * TRAIN_STEPS)
# The per-view phase regenerates dataset view 3, as the per-view loop
# regenerates every dataset view.
TARGET_VIEW = 3


def to_world(parsed, points):
    """Scene-frame points [..., 3] -> the NeRF's world frame."""
    import numpy as np

    t = np.asarray(parsed.dataparser_transform, np.float64)
    return (np.asarray(points, np.float64) @ t[:3, :3].T + t[:3, 3]) * parsed.dataparser_scale


def phase_reference_sheet(torch, card: str, tmp: Path, white_ckpt: Path) -> dict:
    """The dataset generator's first stage on the card: a signerf_nerfacto
    NeRF trained by the train CLI on the grey-backdrop scene, its renders,
    masks, conditions, the proxy raster, the composed sheet and the
    per-view phase's target view; and phase 7's NeRF (`white_ckpt`, the
    white scene) under the same box, for comparison."""

    import numpy as np

    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.editing import conditions as ec
    from signerf_tpu_torch.editing import sheet as es
    from signerf_tpu_torch.editing.morphology import dilate
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.geometry import obj, primitives, raster
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.ops.image_metrics import psnr as psnr_fn
    from signerf_tpu_torch.utils.images import load_rgb

    dev = torch.device("cuda")
    data = write_scene(tmp / "reference_scene", REFERENCE_BACKDROP)
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    cams = parsed.cameras.to(dev)
    h, w = cams.height, cams.width
    chunks = -(-(h * w) // CHUNK)
    scene_aabb = torch.as_tensor(parsed.scene_box_aabb, device=dev)
    corners = to_world(parsed, list(itertools.product(*zip(*SHEET_AABB_SCENE))))
    mcfg = ec.MaskingConfig(masking_mode="aabb", aabb_min=tuple(corners.min(0)), aabb_max=tuple(corners.max(0)),
                            mask_dilation=MASK_DILATION)
    scfg = ec.MaskingConfig(masking_mode="shape", mask_dilation=MASK_DILATION)
    verts, faces = primitives.bunny(3)
    pose = obj.object_pose_matrix(to_world(parsed, BUNNY_SCENE["position"]), BUNNY_SCENE["rotation"],
                                  [BUNNY_SCENE["scale"] * parsed.dataparser_scale] * 3)
    verts = obj.transform_vertices(verts, pose).astype(np.float32)
    empty_cells = []  # empty AABB masks after each schedule
    for steps in REFERENCE_STEPS:
        out = tmp / f"reference_nerf_{steps}"
        zero_counts(ffc)
        t0 = time.perf_counter()
        rc = train_cli.main(train_argv("signerf_nerfacto", data, out, steps, *REFERENCE_FLAGS))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if rc != 0 or counts(ffc) != NERFACTO_COUNTS(steps):
            fail(f"the reference NeRF's train CLI: rc {rc}, launches {counts(ffc)}")
        model = NerfactoModel(NerfactoModelConfig(background_color=REFERENCE_FLAGS[1]), len(cams))
        ckpt_dir = out / "experiment" / "signerf_nerfacto" / "checkpoints"
        model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
        model = model.to(dev).eval()
        render = make_eval_render(model, chunk_size=CHUNK)
        acc_means = []

        def view(i):
            rb = cams.generate_rays(camera_index=i, aabb=scene_aabb)
            out = render(rb.reshape((h * w,)), appearance_mode="index")
            acc_means.append(out["accumulation"].mean())
            rgb, depth = out["rgb"].reshape(h, w, 3), out["depth"].reshape(h, w, 1)
            mask, cond = ec.aabb_mask_condition(depth, rb.origins, rb.directions, mcfg)
            return rgb, depth, mask, cond

        torch.cuda.synchronize()
        zero_counts(ffc)
        t0 = time.perf_counter()
        refs = [view(i) for i in range(len(cams))]
        torch.cuda.synchronize()
        views_s = time.perf_counter() - t0
        if counts(ffc) != expect_counts(K1=3)(chunks * len(cams)):
            fail(f"the reference views launched {counts(ffc)}, expected K1 3 x {chunks} chunks x {len(cams)} views")
        empty_cells.append(sum(int(float(m.max()) == 0.0) for _, _, m, _ in refs))
        print(f"phase 14c reference NeRF after {steps} steps: {empty_cells[-1]} of {len(refs)} AABB masks empty",
              flush=True)
        if not empty_cells[-1]:
            break
    raster_s, shape_cov = [], []
    for i, (_, depth, _, _) in enumerate(refs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, mesh_depth = raster.mesh_depth_render(cams, verts, faces, camera_index=i)
        torch.cuda.synchronize()
        raster_s.append(time.perf_counter() - t0)
        smask, scond = ec.shape_mask_condition(depth, mesh_depth, scfg)
        if not (bool(torch.isfinite(scond).all()) and float(scond.min()) >= 0.0 and float(scond.max()) <= 1.0):
            fail(f"reference view {i}: shape condition not finite or outside [0, 1]")
        shape_cov.append(float(smask.mean()))
    dilate_ms = cuda_ms(lambda: dilate(refs[0][2], MASK_DILATION), 10)

    layout = es.SheetLayout(rows=SHEET_GRID, cols=SHEET_GRID, cell_height=SHEET_CELL, cell_width=SHEET_CELL)
    if (layout.height, layout.width) != (SHEET_GRID * SHEET_CELL,) * 2 or (h, w) != (SHEET_CELL,) * 2:
        fail(f"sheet layout {layout} does not match the {h}x{w} views")

    def cells(rgb, mask, cond):
        return (es.resize_bilinear(rgb, SHEET_CELL, SHEET_CELL), es.resize_mask(mask, SHEET_CELL, SHEET_CELL),
                es.resize_bilinear(cond, SHEET_CELL, SHEET_CELL))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scaled = [cells(rgb, mask, cond) for rgb, _, mask, cond in refs]
    image_sheet, mask_sheet, cond_sheet = es.compose_sheet(layout, *zip(*scaled))
    torch.cuda.synchronize()
    compose_ms = (time.perf_counter() - t0) * 1e3
    coverage = [float(c[1].mean()) for c in scaled]
    flips = sum(int((es.resize_mask(m, h // 2, w // 2).cpu() != es.resize_mask(m.cpu(), h // 2, w // 2)).sum())
                for _, _, m, _ in refs)
    for name, t in (("image", image_sheet), ("mask", mask_sheet), ("condition", cond_sheet)):
        if not bool(torch.isfinite(t).all()) or float(t.min()) < 0.0 or float(t.max()) > 1.0:
            fail(f"the reference sheet's {name} is not finite or outside [0, 1]")
    if min(coverage) == 0.0:
        fail(f"a reference cell's mask is empty: coverage {coverage}")


    white = NerfactoModel(NerfactoModelConfig(), len(cams))
    white.load_state_dict(load_checkpoint(latest_checkpoint(white_ckpt))["params"], strict=True)
    white_render = make_eval_render(white.to(dev).eval(), chunk_size=CHUNK)
    white_acc, white_cov = [], []
    for i in range(len(cams)):
        rb = cams.generate_rays(camera_index=i, aabb=scene_aabb)
        out = white_render(rb.reshape((h * w,)), appearance_mode="index")
        mask, _ = ec.aabb_mask_condition(out["depth"].reshape(h, w, 1), rb.origins, rb.directions, mcfg)
        white_acc.append(float(out["accumulation"].mean()))
        white_cov.append(float(mask.mean()))
    gts = [torch.from_numpy(load_rgb(f)).to(dev).float() / 255.0 for f in parsed.image_filenames]
    psnr = [float(psnr_fn(rgb, gt)) for (rgb, _, _, _), gt in zip(refs, gts)]
    print(f"phase 14c reference sheet: signerf_nerfacto trained {steps} steps by the train CLI on the scene "
          f"with a {REFERENCE_BACKDROP} grey backdrop ({' '.join(REFERENCE_FLAGS)}) in {train_s:.3f} s; its {len(refs)} "
          f"views of {w}x{h} in {views_s:.3f} s (K1 {3 * chunks} launches a view), PSNR "
          + ", ".join(f"{v:.2f}" for v in psnr) + f" dB; AABB masks (box {np.round(corners.min(0), 3).tolist()} "
          f"to {np.round(corners.max(0), 3).tolist()}, dilation {MASK_DILATION}) cover "
          + ", ".join(f"{c:.3f}" for c in coverage)
          + f" of each cell; bunny(3) proxy ({len(faces)} triangles) ray-traced in "
          + ", ".join(f"{s * 1e3:.1f}" for s in raster_s)
          + " ms a view, shape masks cover " + ", ".join(f"{c:.3f}" for c in shape_cov)
          + f"; dilation {dilate_ms:.3f} ms a {w}x{h} mask; compose {compose_ms:.3f} ms; condition sheet "
          f"{float(cond_sheet.min()):.3f} to {float(cond_sheet.max()):.3f}; resize_mask {h} -> {h // 2} on the card vs "
          f"the CPU: {flips} flipped pixels over {len(refs)} masks. Phase 7's NeRF (the white scene) on the same views and box: mean "
          f"accumulation " + ", ".join(f"{a:.4f}" for a in white_acc) + ", AABB masks cover "
          + ", ".join(f"{c:.3f}" for c in white_cov) + f"; on {card}", flush=True)
    return {"layout": layout, "image_sheet": image_sheet, "mask_sheet": mask_sheet, "cond_sheet": cond_sheet,
            "target": scaled[TARGET_VIEW], "count": len(refs), "coverage": coverage, "data": data,
            "ckpt_dir": ckpt_dir, "psnr": psnr, "accumulation": [float(a) for a in acc_means],
            "empty_cells": empty_cells}


# The edit pass (phase 14d): SIGNeRF's product path through the trainer API
# on phase 14c's grey-backdrop scene, at the generator's defaults (a 2 x 3
# sheet, downscale 2: cells of 256 px, a 512 x 768 sheet, latent 64 x 96)
# and the diffuser's. Its reference poses are a circle in the scene's frame:
# the dataset cameras' ring at their first 5 azimuths (a NeRF trained 300
# steps on 8 views renders floaters in front of poses between or off them,
# and their masks come out empty: 2 of 5 at 72-degree steps on this ring,
# all 5 on a ring at 60 degrees).
EDIT_STEPS = TRAIN_STEPS
# num_inference_steps of the edit flows' generation in 14d, 14f and 22 (4
# sampler steps at strength 0.9, not the default 20: the smoke's time);
# phase 16 runs the default 20 on the 1536 px sheet.
EDIT_SDXL_STEPS = 5
EDIT_REFERENCES = 5
EDIT_REFERENCE_RING = dict(radius=2.0, theta=70.0, phi=(0.0, 180.0))
EDIT_CLI_STEPS = 50
EDIT_MESH_RESOLUTION = 64
EDIT_MESH_ISO = "p90"
# Self-attention calls of one UNet + ControlNet pass by head count: 14 with
# 10 heads at latent / 2 (UNet 10, ControlNet 4), 90 with 20 heads at
# latent / 4 (UNet 60, ControlNet 30).
K7_PASS_CALLS = {10: 14, 20: 90}
K7_LAYERS = sum(K7_PASS_CALLS.values())


def k7_pass_shapes(h: int, w: int, batch: int) -> dict:
    """{(B, S, H): calls} of one UNet + ControlNet pass on an h x w image."""
    return {(batch, (h // 16) * (w // 16), 10): K7_PASS_CALLS[10], (batch, (h // 32) * (w // 32), 20): K7_PASS_CALLS[20]}


# The edit pass's shapes: at 512 x 768 CFG is batched (the pipeline's
# einsum-memory gate), so the sheet call runs B = 2 and a chunk of 4 views
# B = 8 (4 views x 2 branches). Phase 15 times them; phase 14d fails if the
# pipeline scheduled others.
K7_EDIT_SHAPES = tuple(k7_pass_shapes(512, 768, 2)) + tuple(k7_pass_shapes(512, 768, 8))


def scene_poses_to_world(parsed, c2w):
    """Scene-frame camera poses [n, 3|4, 4] -> the NeRF's world frame [n, 3, 4]
    (the dataparser's transform, then its scale on the translation)."""
    import numpy as np

    rot = np.asarray(parsed.dataparser_transform, np.float64)[:3, :3]
    c2w = np.asarray(c2w, np.float64)
    return np.concatenate([rot @ c2w[:, :3, :3], to_world(parsed, c2w[:, :3, 3])[..., None]], 2).astype(np.float32)


def recording_diffuser(diffuser, calls: list):
    """Record, after each `diffuse` / `diffuse_batch` call, its image count
    and the in-process pipeline's `last_run` (what it scheduled)."""

    def wrap(fn, batched):
        def call(images, *args, **kw):
            out = fn(images, *args, **kw)
            calls.append((len(images) if batched else 1, dict(diffuser.pipeline.last_run)))
            return out

        return call

    diffuser.diffuse = wrap(diffuser.diffuse, False)
    diffuser.diffuse_batch = wrap(diffuser.diffuse_batch, True)
    return diffuser


def k7_launches(calls: list, h: int, w: int) -> dict:
    """{(B, S, H): launches} of the recorded diffuse calls on h x w sheets:
    a call runs its sampler steps, each one pass per CFG branch when CFG is
    sequential, one pass over both otherwise; serial views run each view as
    its own call."""
    shapes = {}
    for k, run in calls:
        views, batch = (k, 1) if run["serial_views"] else (1, k)
        branches, batch = (2, batch) if run["sequential_cfg"] else (1, 2 * batch)
        for shape, n in k7_pass_shapes(h, w, batch).items():
            shapes[shape] = shapes.get(shape, 0) + n * run["sampler_steps"] * branches * views
    return shapes


def check_generated(generated: Path, gen, views: int, label: str):
    """The generated dataset's schema at EDIT_REFERENCES references and
    `views` regenerated originals: transforms.json's indices, every PNG at
    full and cell size, the dataparser's read-back. Returns (transforms.json,
    {PNG: (h, w)}, each view's mask coverage at cell size)."""
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms

    cfg = gen.config
    h, w, ds = int(cfg.height), int(cfg.width), cfg.downscale_factor
    sheet_h, sheet_w = gen._layout().height, gen._layout().width
    meta = json.loads((generated / "transforms.json").read_text())
    refs, gens = list(range(EDIT_REFERENCES)), list(range(EDIT_REFERENCES, EDIT_REFERENCES + views))
    if (len(meta["frames"]), meta["reference_indices"], meta["generated_indices"]) != (len(refs + gens), refs, gens):
        fail(f"{label}: transforms.json has {len(meta['frames'])} frames, reference_indices "
             f"{meta.get('reference_indices')}, generated_indices {meta.get('generated_indices')}")
    cell_h, cell_w = h // ds, w // ds
    expected = {f"references/{k}_reference_sheet.png": (sheet_h, sheet_w) for k in ("image", "mask", "condition",
                                                                                    "edited")}
    for i in refs + gens:
        for sub, name in (("images", "image"), ("masks", "mask"), ("conditions", "condition")):
            expected[f"{sub}/{name}_{i}.png"] = (h, w)
            expected[f"{sub}_{ds}/{name}_{i}.png"] = (cell_h, cell_w)
        expected[f"{'rendered' if i in refs else 'originals'}/image_{i}.png"] = (h, w)
        expected[f"rendered_{ds}/image_{i}.png"] = (cell_h, cell_w)
    written = {p.relative_to(generated).as_posix() for p in generated.rglob("*.png")}
    if written != set(expected):
        fail(f"{label}: PNGs missing {sorted(set(expected) - written)[:5]}, unexpected "
             f"{sorted(written - set(expected))[:5]}")
    for name, hw in expected.items():
        if read_png(generated / name).shape[:2] != hw:
            fail(f"{label}: {name} is not {hw}")
    coverage = [float(read_png(generated / f"masks_{ds}/mask_{i}.png").mean()) / 255.0 for i in refs + gens]
    reread = parse_transforms(SIGNeRFDataParserConfig(data=generated))
    if len(reread.image_filenames) != len(refs + gens) or (reread.cameras.height, reread.cameras.width) != (h, w):
        fail(f"{label}: the dataparser read {len(reread.image_filenames)} frames of "
             f"{reread.cameras.width}x{reread.cameras.height} back")
    return meta, expected, coverage


def phase_edit_pass(torch, card: str, tmp: Path, ref: dict) -> dict:
    """SIGNeRF's edit pass through the trainer API at full width: train
    `signerf_nerfacto`, generate the edited dataset (reference sheet,
    per-view regeneration in chunks of 4, PNGs, transforms.json), hot-swap
    it, refine; then the headless train CLI on the generated dataset and
    both export subcommands on the refined checkpoint."""
    import gc
    import warnings

    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.diffusion.diffuser import Diffuser
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.engine.checkpoints import load_checkpoint
    from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
    from signerf_tpu_torch.method_configs import signerf_nerfacto_method
    from signerf_tpu_torch.ops import flash_attention as fa
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.pipeline import SURGERY_SEED, seeded_model

    dev = torch.device("cuda")
    data = ref["data"]
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    corners = to_world(parsed, list(itertools.product(*zip(*SHEET_AABB_SCENE))))
    cfg = signerf_nerfacto_method()
    cfg.output_dir = tmp / "edit"
    cfg.pipeline.datamanager.dataparser.data = data
    cfg.pipeline.model.background_color = REFERENCE_FLAGS[1]
    cfg.max_num_iterations = cfg.steps_per_save = EDIT_STEPS
    gen_cfg = cfg.pipeline.dataset_generator
    gen_cfg.diffuser.num_inference_steps = EDIT_SDXL_STEPS
    gen_cfg.path = tmp / "generations"
    gen_cfg.aabb_min, gen_cfg.aabb_max = tuple(corners.min(0)), tuple(corners.max(0))
    h, w = SCENE["height"], SCENE["width"]
    chunks = -(-(h * w) // CHUNK)

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    diffuse_calls = []
    trainer = SIGNeRFTrainer(cfg, dev)
    trainer.setup(diffuser=recording_diffuser(Diffuser(gen_cfg.diffuser, device=dev), diffuse_calls))
    zero_counts(ffc)
    t0 = synced()
    trainer.train()
    train_s = synced() - t0
    if counts(ffc) != NERFACTO_COUNTS(EDIT_STEPS):
        fail(f"edit pass: training launched {counts(ffc)}, expected {NERFACTO_COUNTS(EDIT_STEPS)}")

    ring = circle_poses(EDIT_REFERENCES, **EDIT_REFERENCE_RING).numpy()
    references = scene_poses_to_world(parsed, ring)
    zero_counts(ffc)
    fa.launches = 0
    t0 = synced()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        generated = trainer.generate_dataset(reference_camera_to_worlds=references)
    gen_s = synced() - t0
    gen = trainer.pipeline.dataset_generator
    timings = dict(gen.last_timings)
    views = len(parsed.image_filenames)
    sheet_h, sheet_w = gen._layout().height, gen._layout().width
    k7_shapes = k7_launches(diffuse_calls, sheet_h, sheet_w)
    k7_expected = sum(k7_shapes.values())
    got = counts(ffc)
    if not any("RANDOM-INIT" in str(x.message) for x in caught):
        fail("edit pass: SDXL ran at random init without the uncalibrated warning")
    if got != expect_counts(K1=3)(chunks * (EDIT_REFERENCES + views)):
        fail(f"edit pass: generation launched {got}, expected K1 3 x {chunks} chunks x {EDIT_REFERENCES + views} "
             f"renders")
    if fa.launches != k7_expected or set(k7_shapes) - set(K7_EDIT_SHAPES):
        fail(f"edit pass: K7 launched {fa.launches} times, expected {k7_expected} from the pipeline's schedule "
             f"{k7_shapes} (phase 15 times {K7_EDIT_SHAPES})")

    refs, gens = list(range(EDIT_REFERENCES)), list(range(EDIT_REFERENCES, EDIT_REFERENCES + views))
    meta, expected, coverage = check_generated(generated, gen, views, "edit pass")
    ds = gen_cfg.downscale_factor
    cell_h, cell_w = h // ds, w // ds

    ckpt_before = {k: v.detach().cpu().clone() for k, v in trainer.pipeline.model.state_dict().items()}
    losses = []
    real_loss = tts.default_loss_fn

    def recording_loss(model, outputs, batch):
        total, ld = real_loss(model, outputs, batch)
        losses.append(total.detach())
        return total, ld

    tts.default_loss_fn = recording_loss
    try:
        zero_counts(ffc)
        t0 = synced()
        trainer.exchange_training_dataset(generated)
        exchange_s = synced() - t0
        if any(counts(ffc).values()) or trainer.step != 0:
            fail(f"edit pass: the exchange launched {counts(ffc)}, step {trainer.step}")
        ckpt = load_checkpoint(sorted(trainer.checkpoint_dir.glob("step-*.pt"))[-1])["params"]
        fresh = seeded_model(cfg.pipeline.model, len(refs + gens), SURGERY_SEED).state_dict()
        swapped = {k: v.detach().cpu() for k, v in trainer.pipeline.model.state_dict().items()}
        reinit = [k for k in swapped if k.startswith("proposal") or k.startswith("field.appearance.")]
        for key, val in swapped.items():
            want = fresh[key] if key in reinit else ckpt[key]
            if not torch.equal(val, want) or (key not in reinit and not torch.equal(val, ckpt_before[key])):
                fail(f"edit pass: after the exchange {key} is not the "
                     f"{'fresh init' if key in reinit else 'checkpoint'}'s")
        if not any(not torch.equal(swapped[k], ckpt_before[k]) for k in reinit if k.startswith("proposal")):
            fail("edit pass: the proposal networks were not re-initialised")
        zero_counts(ffc)
        t0 = synced()
        trainer.train()
        refine_s = synced() - t0
    finally:
        tts.default_loss_fn = real_loss
    if counts(ffc) != NERFACTO_COUNTS(EDIT_STEPS):
        fail(f"edit pass: refinement launched {counts(ffc)}, expected {NERFACTO_COUNTS(EDIT_STEPS)}")
    loss = torch.stack(losses).float().cpu()
    first, last = float(loss[:20].mean()), float(loss[-20:].mean())
    if len(loss) != EDIT_STEPS or not bool(torch.isfinite(loss).all()) or not last < first:
        fail(f"edit pass: {len(loss)} refinement losses, finite {bool(torch.isfinite(loss).all())}, first 20 "
             f"{first:.5f}, last 20 {last:.5f}")
    out = trainer.pipeline.render_camera_fn(trainer.pipeline.datamanager.cameras, gens[0])
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        fail("edit pass: the refined NeRF renders non-finite values")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ckpt_dir = trainer.checkpoint_dir
    view_s = timings["view_s"]
    per_view = sorted(s / gen_cfg.generation_batch_size for s in view_s)
    run0 = diffuse_calls[0][1]
    step_ms = []
    for _, run in diffuse_calls:
        ev = run["step_events"]
        ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1))
        step_ms.append(f"{ms[len(ms) // 2]:.2f} ({ms[0]:.2f} to {ms[-1]:.2f})")
    sdxl_init_s = gen.diffuser.pipeline.init_seconds
    print(f"phase 14d edit pass (trainer API, phase 14c's scene, {views} cameras of {w}x{h}): signerf_nerfacto "
          f"trained {EDIT_STEPS} steps in {train_s:.3f} s; generate_dataset at the generator's defaults ("
          f"{gen_cfg.rows}x{gen_cfg.cols} sheet of {cell_w}x{cell_h} cells = {sheet_w}x{sheet_h}, downscale "
          f"{ds}, generation_batch_size {gen_cfg.generation_batch_size}, lastcell_vae_window "
          f"{gen_cfg.lastcell_vae_window}) and the diffuser's but its steps ({gen_cfg.diffuser.mode}, "
          f"{gen_cfg.diffuser.num_inference_steps} steps, strength {gen_cfg.diffuser.denoising_strength}, CFG "
          f"{gen_cfg.diffuser.guidance_scale}, ControlNet {gen_cfg.diffuser.controlnet_conditioning_scale}; SDXL "
          f"random init, warned) with {EDIT_REFERENCES} reference poses and the {views} originals: {gen_s:.3f} s "
          f"in all, sheet {timings['sheet_s']:.3f} s (SDXL created in it: {sdxl_init_s:.2f} s), per-view chunks "
          + ", ".join(f"{x:.3f}" for x in view_s)
          + f" s (per view median {per_view[len(per_view) // 2]:.3f} s, range {per_view[0]:.3f} to "
          f"{per_view[-1]:.3f}); {len(diffuse_calls)} diffuse calls, sequential CFG "
          f"{[r['sequential_cfg'] for _, r in diffuse_calls]}, serial views "
          f"{[r['serial_views'] for _, r in diffuse_calls]}, {run0['sampler_steps']} sampler steps a call, step "
          f"median (range) " + ", ".join(step_ms) + " ms; launches "
          f"K1 {got['K1']} (= 3 x {chunks} x {EDIT_REFERENCES + views}), K7 {fa.launches} ("
          + ", ".join(f"{n} at {s}" for s, n in k7_shapes.items()) + f"), others 0; transforms.json "
          f"{len(meta['frames'])} frames, {len(expected)} PNGs at full and cell size, mask coverage "
          + ", ".join(f"{c:.3f}" for c in coverage) + f", read back by the dataparser; exchange {exchange_s:.3f} s "
          f"(step 0, proposal networks and appearance codes from the seeded init, the rest the checkpoint's); "
          f"refinement {EDIT_STEPS} steps in {refine_s:.3f} s, loss {float(loss[0]):.5f} -> {float(loss[-1]):.5f} "
          f"(first 20 {first:.5f}, last 20 {last:.5f}), K1 and K2's tables half 3 x {EDIT_STEPS}, no coords half; "
          f"peak memory {peak:.2f} GiB; on {card}", flush=True)
    trainer.pipeline.dataset_generator.diffuser._sdxl = None
    del trainer, gen, out
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_edit_clis(torch, card, tmp, data, generated, ckpt_dir)
    return {"train_steps": 2 * EDIT_STEPS + EDIT_CLI_STEPS, "chunks": chunks * (EDIT_REFERENCES + views)
            + cli["pointcloud_chunks"], "mesh_calls": cli["mesh_calls"], "k7_shapes": k7_shapes,
            "k7_launches": fa.launches, "K1": 3 * 2 * EDIT_STEPS + got["K1"] + cli["K1"],
            "K2 tables": 3 * 2 * EDIT_STEPS + cli["K2 tables"]}


def phase_edit_clis(torch, card: str, tmp: Path, data: Path, generated: Path, ckpt_dir: Path) -> dict:
    """Phase 14e: the headless train CLI on the generated dataset (straight
    to the exchange), then `export pointcloud` and `export mesh` on the
    refined checkpoint, each with its K1 launches."""
    from signerf_tpu_torch import export
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.geometry.obj import load_obj
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    model_flag = ("--pipeline.model.background-color", REFERENCE_FLAGS[1])
    out = tmp / "edit_cli"
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = train_cli.main(["signerf_nerfacto", "--data", str(data), "--mesh", "none", "--skip-interface", "True",
                         "--skip-generation",
                         "True", "--generated-dataset-dir", str(generated), "--load-dir", str(ckpt_dir), "--device",
                         "cuda", "--max-num-iterations", str(EDIT_CLI_STEPS), "--steps-per-save", str(EDIT_CLI_STEPS),
                         "--output-dir", str(out), *model_flag])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = counts(ffc)
    ckpts = sorted(p.name for p in (out / "experiment" / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    if rc != 0 or cli_counts != NERFACTO_COUNTS(EDIT_CLI_STEPS) or ckpts != ["step-000000000.pt",
                                                                          f"step-{EDIT_CLI_STEPS:09d}.pt"]:
        fail(f"headless CLI: rc {rc}, launches {cli_counts}, checkpoints {ckpts}")

    export_flags = ["--data", str(data), "--load-dir", str(ckpt_dir), "--device", "cuda", "--model.background-color",
                    REFERENCE_FLAGS[1]]
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = export.main(["pointcloud", "--output", str(tmp / "edit.ply"), *export_flags])
    torch.cuda.synchronize()
    pc_s = time.perf_counter() - t0
    pc_counts = counts(ffc)
    side = SCENE["width"] // 2  # --downscale 2, the default
    pc_chunks = SCENE["cameras"] * -(-(side * side) // CHUNK)
    points = export.read_ply_header(tmp / "edit.ply") if rc == 0 else 0
    if rc != 0 or points <= 0 or pc_counts != expect_counts(K1=3)(pc_chunks):
        fail(f"export pointcloud: rc {rc}, {points} points, launches {pc_counts}, expected K1 3 x {pc_chunks}")

    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = export.main(["mesh", "--output", str(tmp / "edit.obj"), "--resolution", str(EDIT_MESH_RESOLUTION),
                      "--iso", EDIT_MESH_ISO, *export_flags])
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_counts = counts(ffc)
    mesh_calls = -(-((EDIT_MESH_RESOLUTION + 1) ** 3) // (1 << 16))
    verts, faces = load_obj(tmp / "edit.obj") if rc == 0 else ([], [])
    if rc != 0 or len(faces) == 0 or mesh_counts != expect_counts(K1=1)(mesh_calls):
        fail(f"export mesh: rc {rc}, {len(faces)} faces, launches {mesh_counts}, expected K1 {mesh_calls}")
    print(f"phase 14e edit-flow CLIs: the headless train CLI on the generated dataset (--skip-interface True "
          f"--skip-generation True, {EDIT_CLI_STEPS} steps) exit 0 in {cli_s:.3f} s, checkpoints {ckpts}, launches "
          f"K1 {cli_counts['K1']}, K2 tables {cli_counts['K2 tables']}; export pointcloud (downscale 2) {points} "
          f"points in {pc_s:.3f} s, K1 {pc_counts['K1']} (= 3 x {pc_chunks} chunks); export mesh (resolution "
          f"{EDIT_MESH_RESOLUTION}, iso {EDIT_MESH_ISO}) {len(verts)} vertices, {len(faces)} faces in {mesh_s:.3f} s, "
          f"K1 {mesh_counts['K1']} (one a chunk of 65,536 points); on {card}", flush=True)
    return {"pointcloud_chunks": pc_chunks, "mesh_calls": mesh_calls,
            "K1": cli_counts["K1"] + pc_counts["K1"] + mesh_counts["K1"], "K2 tables": cli_counts["K2 tables"]}


# Phase 14f: the interface, the product's normal way in. The train CLI
# without --skip-interface serves the web viewer on port 7007, training
# paused; the user orbits the NeRF, places the selection, previews the sheet
# and clicks "Generate Dataset & Train". On phase 14c's scene and
# checkpoint, at the defaults (signerf_nerfacto at full width; the
# Diffuser's torch_sdxl on SDXL at random init).
VIEWER_PORT = 7007
VIEWER_SIZES = (128, 256, 512)
VIEWER_REPEATS = 5  # timed /render requests a size, after one warm-up
VIEWER_STEPS = TRAIN_STEPS  # each training run, without and with a client
VIEWER_CLIENT_FPS = 2.0
VIEWER_VIEW = "yaw=30&pitch=60&radius=2.0"


def http_get(url: str, timeout: float = 300.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers, r.read()


def http_post(url: str, body: dict, timeout: float = 600.0):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def server_timing(headers) -> dict:
    """{span: ms} of a /render reply's Server-Timing header (lock, render, png)."""
    return {k: float(v) for k, v in (s.split(";dur=") for s in headers["Server-Timing"].split(", "))}


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_viewer_cli(tmp: Path, data: Path, ckpt_dir: Path) -> dict:
    """The train CLI without --skip-interface, in a subprocess: wait for
    /state on VIEWER_PORT, GET /render at 128 px, terminate it."""
    import urllib.error

    from signerf_tpu_torch.utils.images import decode_png

    log = tmp / "viewer_cli.log"
    cmd = [sys.executable, "-m", "signerf_tpu_torch.train", "signerf_nerfacto", "--data", str(data), "--load-dir",
           str(ckpt_dir), "--device", "cuda", "--mesh", "none", "--output-dir", str(tmp / "viewer_cli"),
           *REFERENCE_FLAGS]
    base = f"http://127.0.0.1:{VIEWER_PORT}"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
    try:
        state = None
        while state is None:
            if proc.poll() is not None:
                fail(f"phase 14f: the train CLI exited {proc.returncode} before serving: {log.read_text()[-2000:]}")
            if time.perf_counter() - t0 > 180:
                fail("phase 14f: the train CLI served no /state within 180 s")
            try:
                state = json.loads(http_get(base + "/state", timeout=5)[1])
            except (urllib.error.URLError, OSError):
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        headers, body = http_get(f"{base}/render?{VIEWER_VIEW}&size=128")
        render_s = time.perf_counter() - t1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    said = log.read_text()
    img = decode_png(body)
    if (state["training_state"], state["step"]) != ("paused", 0) or img.shape != (128, 128, 3):
        fail(f"phase 14f: the train CLI's viewer: state {state}, /render {img.shape}")
    if f"[viewer] http://0.0.0.0:{VIEWER_PORT}" not in said or "viewer dependencies unavailable" in said:
        fail(f"phase 14f: the train CLI did not start the viewer: {said[-2000:]}")
    return {"up_s": up_s, "render_s": render_s, "png": img, "timing": server_timing(headers)}


def phase_viewer(torch, card: str, tmp: Path, ref: dict) -> dict:
    """The interface on the card: the train CLI's viewer (subprocess), then
    the viewer in process over a trainer on phase 14c's checkpoint: paused
    /render at three sizes, two training runs (without and with a client at
    VIEWER_CLIENT_FPS, the replies at the throttled size, a pause and a
    resume), /export of both kinds, /preview and /generate, each with exact
    launches."""
    import base64
    import gc
    import threading
    import warnings

    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.diffusion.diffuser import Diffuser
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.engine import writer
    from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
    from signerf_tpu_torch.interface import GenerationInterface
    from signerf_tpu_torch.interface.app import ViewerServer
    from signerf_tpu_torch.method_configs import signerf_nerfacto_method
    from signerf_tpu_torch.ops import flash_attention as fa
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc
    from signerf_tpu_torch.utils.images import decode_png

    dev = torch.device("cuda")
    data, ckpt_dir = ref["data"], ref["ckpt_dir"]
    cli = phase_viewer_cli(tmp, data, ckpt_dir)
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    views = len(parsed.image_filenames)
    corners = to_world(parsed, list(itertools.product(*zip(*SHEET_AABB_SCENE))))
    cfg = signerf_nerfacto_method()
    cfg.output_dir = tmp / "viewer"
    cfg.load_dir = ckpt_dir
    cfg.pipeline.datamanager.dataparser.data = data
    cfg.pipeline.model.background_color = REFERENCE_FLAGS[1]
    cfg.pipeline.dataset_generator.path = tmp / "viewer_generations"
    h, w = SCENE["height"], SCENE["width"]
    frame_chunks = -(-(h * w) // CHUNK)

    def chunks_of(size: int) -> int:
        return -(-(size * size) // CHUNK)

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def step_ms(events):
        return sorted(events[i - 1].elapsed_time(events[i]) for i in range(11, len(events)))

    events = []
    real_loss = tts.default_loss_fn

    def recording_loss(model, outputs, batch):
        total, ld = real_loss(model, outputs, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return total, ld

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    diffuse_calls = []
    chunks = 0  # K1 render chunks over every request of the phase
    tts.default_loss_fn = recording_loss
    httpd = thread = None
    try:
        trainer = SIGNeRFTrainer(cfg, dev)
        trainer.setup(diffuser=recording_diffuser(Diffuser(cfg.pipeline.dataset_generator.diffuser, device=dev),
                                                  diffuse_calls))
        iface = GenerationInterface(trainer)
        server = ViewerServer(iface, port=0)
        httpd = server.start_background()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        # Paused: the size asked, K1 3 x its chunks a request.
        paused, cli_diff = {}, None
        for size in VIEWER_SIZES:
            rows = []
            for rep in range(VIEWER_REPEATS + 1):
                zero_counts(ffc)
                t0 = time.perf_counter()
                headers, body = http_get(f"{base}/render?{VIEWER_VIEW}&size={size}")
                wall = time.perf_counter() - t0
                img = decode_png(body)
                chunks += chunks_of(size)
                if img.shape != (size, size, 3) or counts(ffc) != expect_counts(K1=3)(chunks_of(size)):
                    fail(f"phase 14f: paused /render at {size} px gave {img.shape}, launches {counts(ffc)}, "
                         f"expected K1 3 x {chunks_of(size)}")
                if size == 128 and rep == 0:
                    d = int(np.abs(img.astype(np.int16) - cli["png"].astype(np.int16)).max())
                    if d > 1:
                        fail(f"phase 14f: the CLI's viewer and the in-process one differ by {d} levels at 128 px")
                    cli_diff = d
                if rep:
                    rows.append((wall * 1e3, server_timing(headers)))
            paused[size] = rows

        # Two training runs: without a client, then with one at
        # VIEWER_CLIENT_FPS asking 512 px, each reply at the throttled size
        # (128 px until the first rays/s sample of this run, which lands at
        # the tracker's second tick, 8 calls in), with a pause and a resume.
        # The rates the trainer publishes (every 4 steps): a request may be
        # sized from any that was current while it was in flight.
        published = []

        class RecordingTracker(writer.RaysPerSecTracker):
            def tick(self, num_rays):
                value = super().tick(num_rays)
                published.append(writer.GLOBAL_BUFFER.get("train_rays_per_sec", 0.0))
                return value

        runs = {}
        for client in (False, True):
            trainer.config.max_num_iterations = trainer.step + VIEWER_STEPS
            trainer.rays_tracker = RecordingTracker()
            writer.GLOBAL_BUFFER.pop("train_rays_per_sec", None)
            events.clear()
            zero_counts(ffc)
            replies, pause, mid_request = [], None, 0
            t0 = time.perf_counter()
            thread = threading.Thread(target=trainer.train, daemon=True)
            thread.start()
            while thread.is_alive():
                if not client:
                    time.sleep(0.05)
                    continue
                t_req = time.perf_counter()
                seen = len(published)
                ends = {server.render_size(512)}
                headers, body = http_get(f"{base}/render?{VIEWER_VIEW}&size=512")
                ends.add(server.render_size(512))
                allowed = ends | {server.throttled_size(512, v) for v in published[seen:]}
                size = decode_png(body).shape[0]
                if size not in allowed:
                    fail(f"phase 14f: a /render during training came at {size} px, the throttle allowed {allowed}")
                mid_request += size not in ends
                replies.append((size, (time.perf_counter() - t_req) * 1e3, server_timing(headers)))
                if len(replies) == 2 and pause is None:
                    # paused: the call in flight ends, then the step holds for 1.5 s
                    t_pause = time.perf_counter()
                    http_post(base + "/train", {"state": "paused"})
                    before, after = -1, trainer.step
                    while before != after and time.perf_counter() - t_pause < 30:
                        before = after
                        time.sleep(1.5)
                        after = trainer.step
                    http_post(base + "/train", {"state": "training"})
                    pause = (before, after, time.perf_counter() - t_pause)
                    if before != after or trainer.training_state != "training":
                        fail(f"phase 14f: paused training went on: step {before}, then {after}")
                time.sleep(max(0.0, 1.0 / VIEWER_CLIENT_FPS - (time.perf_counter() - t_req)))
            thread.join()
            wall = synced() - t0
            want = expect_counts(K1=3, K2_tables=3)(VIEWER_STEPS)
            want["K1"] += 3 * sum(chunks_of(s) for s, _, _ in replies)
            chunks += sum(chunks_of(s) for s, _, _ in replies)
            if counts(ffc) != want or len(events) != VIEWER_STEPS:
                fail(f"phase 14f: training {'with' if client else 'without'} a client launched {counts(ffc)}, "
                     f"expected {want}; {len(events)} losses")
            if client and (pause is None or not replies):
                fail(f"phase 14f: {len(replies)} replies during training, pause {pause}")
            runs[client] = {"wall": wall, "steps": step_ms(events), "replies": replies, "pause": pause,
                            "mid_request": mid_request,
                            "rays_per_sec": writer.GLOBAL_BUFFER.get("train_rays_per_sec", 0.0)}

        # Exports: the mesh at EDIT_MESH_RESOLUTION (K1 one launch a chunk of
        # 65,536 points), the point cloud at the viewer's downscale 4.
        zero_counts(ffc)
        t0 = synced()
        mesh = http_post(base + "/export", {"kind": "mesh", "resolution": EDIT_MESH_RESOLUTION,
                                            "iso": EDIT_MESH_ISO})
        mesh_s = synced() - t0
        mesh_calls = -(-((EDIT_MESH_RESOLUTION + 1) ** 3) // (1 << 16))
        if mesh.get("faces", 0) <= 0 or counts(ffc) != expect_counts(K1=1)(mesh_calls):
            fail(f"phase 14f: /export mesh {mesh}, launches {counts(ffc)}, expected K1 {mesh_calls}")
        zero_counts(ffc)
        t0 = synced()
        cloud = http_post(base + "/export", {"kind": "pointcloud"})
        cloud_s = synced() - t0
        side = w // 4
        cloud_chunks = views * chunks_of(side)
        chunks += cloud_chunks
        if cloud.get("points", 0) <= 0 or counts(ffc) != expect_counts(K1=3)(cloud_chunks):
            fail(f"phase 14f: /export pointcloud {cloud}, launches {counts(ffc)}, expected K1 3 x {cloud_chunks}")

        # Preview Generation: the reference sheet at the generator's defaults
        # but EDIT_SDXL_STEPS, with the selection and the reference poses
        # placed through the API.
        iface.set_selection_aabb(tuple(corners.min(0)), tuple(corners.max(0)))
        iface.set_reference_poses(scene_poses_to_world(parsed, circle_poses(EDIT_REFERENCES,
                                                                            **EDIT_REFERENCE_RING).numpy()))
        gen = trainer.pipeline.dataset_generator
        http_post(base + "/params", {"num_inference_steps": EDIT_SDXL_STEPS})
        if gen.diffuser.config.num_inference_steps != EDIT_SDXL_STEPS:
            fail(f"phase 14f: /params left num_inference_steps at {gen.diffuser.config.num_inference_steps}")
        zero_counts(ffc)
        fa.launches = 0
        diffuse_calls.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = synced()
            sheets = http_post(base + "/preview", {})
            preview_s = synced() - t0
        sheet_h, sheet_w = gen._layout().height, gen._layout().width
        preview_k7 = k7_launches(diffuse_calls, sheet_h, sheet_w)
        chunks += frame_chunks * EDIT_REFERENCES
        if counts(ffc) != expect_counts(K1=3)(frame_chunks * EDIT_REFERENCES):
            fail(f"phase 14f: /preview launched {counts(ffc)}, expected K1 3 x {frame_chunks} x {EDIT_REFERENCES}")
        if fa.launches != sum(preview_k7.values()) or set(preview_k7) - set(K7_EDIT_SHAPES):
            fail(f"phase 14f: /preview launched K7 {fa.launches} times, the schedule {preview_k7}")
        if not any("RANDOM-INIT" in str(x.message) for x in caught):
            fail("phase 14f: SDXL ran at random init without the uncalibrated warning")
        shapes = {k: decode_png(base64.b64decode(v)).shape for k, v in sheets.items()}
        if shapes != {"image": (sheet_h, sheet_w, 3), "mask": (sheet_h, sheet_w, 1),
                      "condition": (sheet_h, sheet_w, 1), "edited": (sheet_h, sheet_w, 3)}:
            fail(f"phase 14f: /preview sheets {shapes}")
        sdxl_init_s = gen.diffuser.pipeline.init_seconds

        # Generate Dataset & Train: generation, exchange, refinement in the
        # server's worker thread; the step counts restart at the exchange.
        trainer.config.max_num_iterations = trainer.config.steps_per_save = EDIT_STEPS
        zero_counts(ffc)
        fa.launches = 0
        diffuse_calls.clear()
        events.clear()
        t0 = time.perf_counter()
        if http_post(base + "/generate", {}) != {"started": True}:
            fail("phase 14f: /generate did not start")
        while server._worker.is_alive() and time.perf_counter() - t0 < 600:
            time.sleep(0.1)
        generate_s = synced() - t0
        if trainer.training_state != "completed" or trainer.step != EDIT_STEPS:
            fail(f"phase 14f: /generate ended at {trainer.training_state}, step {trainer.step}")
        generated = Path(trainer.config.pipeline.datamanager.dataparser.data)
        meta, expected, coverage = check_generated(generated, trainer.pipeline.dataset_generator, views,
                                                   "phase 14f /generate")
        generate_k7 = k7_launches(diffuse_calls, sheet_h, sheet_w)
        want = expect_counts(K1=3, K2_tables=3)(EDIT_STEPS)
        want["K1"] += 3 * frame_chunks * (EDIT_REFERENCES + views)
        chunks += frame_chunks * (EDIT_REFERENCES + views)
        if counts(ffc) != want or len(events) != EDIT_STEPS:
            fail(f"phase 14f: /generate launched {counts(ffc)}, expected {want}; {len(events)} refinement losses")
        if fa.launches != sum(generate_k7.values()) or set(generate_k7) - set(K7_EDIT_SHAPES):
            fail(f"phase 14f: /generate launched K7 {fa.launches} times, the schedule {generate_k7}")
        timings = dict(gen.last_timings)
        refine_ms = step_ms(events)
        zero_counts(ffc)
        img = decode_png(http_get(f"{base}/render?{VIEWER_VIEW}&size=128")[1])
        chunks += chunks_of(128)
        if img.shape != (128, 128, 3) or counts(ffc) != expect_counts(K1=3)(chunks_of(128)):
            fail(f"phase 14f: /render after /generate gave {img.shape}, launches {counts(ffc)}")
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        if thread is not None and thread.is_alive():  # a check failed: end the run
            trainer.config.max_num_iterations = 0
            trainer.training_state = "training"
            thread.join()
        tts.default_loss_fn = real_loss
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()

    def ms_line(xs):
        return f"{median(xs):.2f} ({min(xs):.2f} to {max(xs):.2f})"

    lat = "; ".join(
        f"{size} px: request {ms_line([r[0] for r in rows])}, lock {ms_line([r[1]['lock'] for r in rows])}, render "
        f"{ms_line([r[1]['render'] for r in rows])}, PNG {ms_line([r[1]['png'] for r in rows])}"
        for size, rows in paused.items())
    quiet, busy = runs[False], runs[True]
    sizes = [s for s, _, _ in busy["replies"]]
    k7_shapes = dict(preview_k7)
    for shape, n in generate_k7.items():
        k7_shapes[shape] = k7_shapes.get(shape, 0) + n
    k7_total = sum(k7_shapes.values())
    print(f"phase 14f viewer: the train CLI without --skip-interface served /state on port {VIEWER_PORT} "
          f"{cli['up_s']:.3f} s after its start and /render at 128 px in {cli['render_s'] * 1e3:.2f} ms (render "
          f"{cli['timing']['render']:.2f} ms), {cli_diff} levels from the in-process viewer's; in process, paused "
          f"/render median (range) over {VIEWER_REPEATS} in ms: {lat}; K1 3 x chunks each; training "
          f"{VIEWER_STEPS} steps without a client: step median {ms_line(quiet['steps'])} ms, wall "
          f"{quiet['wall']:.3f} s, {quiet['rays_per_sec']:.0f} rays/s; with a client asking 512 px at "
          f"{VIEWER_CLIENT_FPS:g} fps: step median {ms_line(busy['steps'])} ms, wall {busy['wall']:.3f} s (a pause of "
          f"{busy['pause'][2]:.3f} s in it, step {busy['pause'][0]} held), {len(sizes)} replies at " + ", ".join(
              f"{s} px x {sizes.count(s)}" for s in sorted(set(sizes)))
          + f" ({busy['mid_request']} sized from a rate published while in flight), request {ms_line([r[1] for r in busy['replies']])} ms, lock wait "
          f"{ms_line([r[2]['lock'] for r in busy['replies']])} ms, render {ms_line([r[2]['render'] for r in busy['replies']])}"
          f" ms; /export mesh (resolution {EDIT_MESH_RESOLUTION}, iso {EDIT_MESH_ISO}) {mesh['vertices']} vertices, "
          f"{mesh['faces']} faces in {mesh_s:.3f} s, K1 {mesh_calls}; /export pointcloud (downscale 4) "
          f"{cloud['points']} points in {cloud_s:.3f} s, K1 3 x {cloud_chunks}; /preview {preview_s:.3f} s (SDXL "
          f"created in it: {sdxl_init_s:.2f} s), K1 3 x {frame_chunks} x {EDIT_REFERENCES}, K7 {sum(preview_k7.values())}"
          f"; /generate {generate_s:.3f} s to completed (sheet {timings['sheet_s']:.3f} s, chunks "
          + ", ".join(f"{x:.3f}" for x in timings["view_s"])
          + f" s, refinement step median {ms_line(refine_ms)} ms), K1 3 x {frame_chunks} x "
          f"{EDIT_REFERENCES + views} + 3 x {EDIT_STEPS}, K2 tables 3 x {EDIT_STEPS}, K7 {sum(generate_k7.values())}, "
          f"transforms.json {len(meta['frames'])} frames, {len(expected)} PNGs, mask coverage "
          + ", ".join(f"{c:.3f}" for c in coverage) + f"; K7 in all {k7_total} ("
          + ", ".join(f"{n} at {s}" for s, n in k7_shapes.items()) + f"); peak memory {peak:.2f} GiB; on {card}",
          flush=True)
    trainer.pipeline.dataset_generator.diffuser._sdxl = None
    del trainer, iface, server, gen
    gc.collect()
    torch.cuda.empty_cache()
    return {"chunks": chunks, "train_steps": 2 * VIEWER_STEPS + EDIT_STEPS, "mesh_calls": mesh_calls,
            "generate_s": generate_s,
            "k7_shapes": k7_shapes, "k7_launches": k7_total}


# Phase 14g: the hash-grid backend (`encoding_backend="hash"`), nerfacto's
# own encoding, at its published widths: the base field 16 levels x 2
# features from 2^19 entries a level (16 to 2048), the proposal fields 5 x 2
# from 2^17 (16 to 128 and to 256). It is plain PyTorch (the JAX function is
# plain jnp), so K1 to K10 must launch 0 times on every hash path.
HASH_FLAG = ("--pipeline.model.encoding-backend", "hash")
# (name, levels, log2 T, max_res, samples per ray) of the three hash tables
HASH_SCHEDULES = [("proposal", 5, 17, 128, 256), ("prop256", 5, 17, 256, 96), ("final", 16, 19, 2048, 48)]
L2_BYTES = 50 * 2**20  # the H100's L2
SECTOR = 32  # bytes a DRAM access moves
# The card's encode (and its table gradient) against the same function in
# float64 on the CPU, max abs error over max |ref| (gradient: norm-relative).
# pos * res rounds in f32 to 2^-24 of res grid units (res up to 2048: 1.2e-4
# of a cell), which moves a feature by that times the corner values'
# difference (tables of +-1 here): up to ~5e-4 of max |ref| (measured 1.4e-4
# at the base field on an H100). Trilinear weights are continuous across
# cells, so a floor that flips at a knot adds nothing more. Against the same
# function in f32 on the CPU the features differ by FMA contraction only, the
# table gradient also by the atomics' order.
HASH_F64_TOL = 1e-3
HASH_F32_TOL = 1e-6
HASH_TRAIN_STEPS = 150  # not 300, for the same reason
HASH_SIGNERF_STEPS = 4
HASH_REPEAT_STEPS = 10


def hash_encode_bound(levels: int, log2_t: int, max_res: int, n: int, backward: bool):
    """The least bytes of one encode call (and of its table gradient), over
    HBM's rate: positions read once, features written once (and the
    cotangent read, the table gradient written once); the table read once
    where the field's whole table fits in L2, else a 32-byte sector for each
    corner read (and each scatter-add) of a hashed level, whose random 8-byte
    reads in a table larger than L2 each cost one."""
    from signerf_tpu_torch.ops.hashgrid import hashgrid_resolutions

    feat, t = 2, 2**log2_t
    table_bytes = levels * t * feat * 4
    nbytes = 12 * n + 4 * levels * feat * n
    for res in hashgrid_resolutions(levels, 16, max_res):
        dense = (res + 1) ** 3 <= t
        level_bytes = min((res + 1) ** 3, t) * feat * 4
        sectors = table_bytes > L2_BYTES and not dense
        nbytes += 8 * n * SECTOR if sectors else level_bytes
        if backward and sectors:
            nbytes += 8 * n * SECTOR
    if backward:
        nbytes += 4 * levels * feat * n + table_bytes
    return bound(nbytes)


def phase_hash_encode(torch, card: str) -> None:
    """(a) `hashgrid_encode` alone on the card at a render chunk's and a
    4096-ray train step's N for each table: forward, and forward +
    backward (the table's gradient), CUDA events, against the bytes bound;
    the card's result and table gradient against float64 on the CPU."""
    from signerf_tpu_torch.ops.hashgrid import hashgrid_encode, hashgrid_resolutions, init_hashgrid_table

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name, levels, log2_t, max_res, per_ray in HASH_SCHEDULES:
        res = hashgrid_resolutions(levels, 16, max_res)
        table = (init_hashgrid_table(gen, levels, 2**log2_t, 2) * 1e4).requires_grad_(True)
        for where, rays in (("chunk", CHUNK), ("train", TRAIN_RAYS)):
            n = rays * per_ray
            x = torch.rand(n, 3, generator=gen, device=dev)
            cot = torch.randn(n, levels * 2, generator=gen, device=dev)
            with torch.no_grad():
                fwd = cuda_ms(lambda: hashgrid_encode(table, x, res), 10)

            def fwd_bwd():
                table.grad = None
                hashgrid_encode(table, x, res).backward(cot)

            both = cuda_ms(fwd_bwd, 10)
            b_f, _ = hash_encode_bound(levels, log2_t, max_res, n, False)
            b_b, _ = hash_encode_bound(levels, log2_t, max_res, n, True)
            out[(name, where)] = {"n": n, "fwd_ms": fwd, "fwd_bwd_ms": both, "bound_fwd_ms": b_f,
                                  "bound_fwd_bwd_ms": b_b}
        # the card against float64 on the CPU at N = 4096
        x = torch.rand(4096, 3, generator=gen, device=dev)
        x[:8] = torch.tensor([0.0, 1.0, 0.5], device=dev)  # the top corner and a clamp bound
        cot = torch.randn(4096, levels * 2, generator=gen, device=dev)
        table.grad = None
        got = hashgrid_encode(table, x, res)
        got.backward(cot)
        errs = []
        for dtype in (torch.float64, torch.float32):
            t_cpu = table.detach().cpu().to(dtype).requires_grad_(True)
            ref = hashgrid_encode(t_cpu, x.cpu().to(dtype), res)
            ref.backward(cot.cpu().to(dtype))
            ref = ref.detach().double()
            errs += [float((got.detach().cpu().double() - ref).abs().max() / ref.abs().max()),
                     rel_err(table.grad.cpu(), t_cpu.grad)]
        out[(name, "cpu")] = errs
        if max(errs[:2]) > HASH_F64_TOL or max(errs[2:]) > HASH_F32_TOL:
            fail(f"hash encode ({name}) on the card vs the CPU (float64 features, gradient; float32 features, "
                 f"gradient): {errs}")
    rows = []
    for (name, where), s in out.items():
        if where == "cpu":
            rows.append(f"{name} at N = 4096 vs float64 on the CPU: features {s[0]:.2e}, table gradient {s[1]:.2e} "
                        f"(bound {HASH_F64_TOL}), vs float32 on the CPU: {s[2]:.2e}, {s[3]:.2e} (bound {HASH_F32_TOL})")
            continue
        rows.append(f"{name} {where} N = {s['n']}: forward {s['fwd_ms']:.3f} ms (bound {s['bound_fwd_ms']:.3f}, "
                    f"{s['bound_fwd_ms'] / s['fwd_ms']:.1%}), forward + backward {s['fwd_bwd_ms']:.3f} ms (bound "
                    f"{s['bound_fwd_bwd_ms']:.3f}, {s['bound_fwd_bwd_ms'] / s['fwd_bwd_ms']:.1%})")
    print("phase 14g(a) hash encode alone (plain PyTorch, bytes-bound: 32-byte sectors for the base table's "
          "hashed levels): " + "; ".join(rows) + f"; on {card}", flush=True)


def phase_hash_render(torch, card: str, data: Path, tmp: Path) -> None:
    """(b) The render CLI with the hash override on phase 6's scene (seeded
    random weights), then warm frames of the same model: rays/s, frame
    median; K1 to K10 launch 0 times."""
    import dataclasses

    from signerf_tpu_torch import render as cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    w, h, arc = SCENE["width"], SCENE["height"], SCENE["arc"]
    argv = ["--data", str(data), "--output", str(tmp / "hash_renders"), "--arc", str(arc), "--device", "cuda",
            "--mesh", "none",
            "--model.encoding-backend", "hash"]
    torch.cuda.synchronize()
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    if rc != 0 or sum(counts(ffc).values()) != 0:
        fail(f"hash render CLI: rc {rc}, launches {counts(ffc)}")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    dev = torch.device("cuda")
    model = cli.build_model(dataclasses.replace(NerfactoModelConfig(), encoding_backend="hash"),
                            len(parsed.image_filenames), dev)
    cams = cli.arc_cameras(parsed.cameras.to(dev), arc, 1.0, 70.0)
    aabb = torch.as_tensor(parsed.scene_box_aabb, device=dev)
    torch.cuda.reset_peak_memory_stats()
    frame_s, frames = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for frame in cli.render_cameras(model, cams, aabb):
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            frames.append(frame)
            t0 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for f in frames:
        acc = f["accumulation"]
        if not all(bool(torch.isfinite(v).all()) for v in f.values()) or float(acc.max()) > 1.0 + 1e-5:
            fail("hash render: non-finite outputs or accumulation above 1")
    warm = sorted(frame_s[arc:])
    median_s = warm[len(warm) // 2]
    print(f"phase 14g(b) render CLI with --model.encoding-backend hash: {arc} x {w}x{h} in "
          f"{arc * -(-(w * h) // CHUNK)} chunks of {CHUNK}, exit 0 in {cli_s:.3f} s ({arc * w * h / cli_s:.0f} rays/s "
          f"incl. start-up and PNG writes), K1 to K10 launches 0; warm frames "
          f"{', '.join(f'{s * 1e3:.1f}' for s in warm)} "
          f"ms, median {median_s * 1e3:.3f} ms = {w * h / median_s:.0f} rays/s (the factor backend: phase 6); peak "
          f"memory {peak:.3f} GiB; on {card}", flush=True)


def view_metrics(torch, model, parsed, box: bool = True):
    """PSNR and mean accumulation of each dataset view, rendered through
    `make_eval_render` with its own appearance code, its rays cut to the
    scene box (as 14c renders them) or, without `box`, between the model's
    near and far planes (as the train step casts them)."""
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.ops.image_metrics import psnr as psnr_fn
    from signerf_tpu_torch.utils.images import load_rgb

    dev = torch.device("cuda")
    cams = parsed.cameras.to(dev)
    aabb = torch.as_tensor(parsed.scene_box_aabb, device=dev)
    render = make_eval_render(model, chunk_size=CHUNK)
    h, w = cams.height, cams.width
    psnr, acc = [], []
    for i, f in enumerate(parsed.image_filenames):
        rays = cams.generate_rays(camera_index=i, aabb=aabb if box else None)
        out = render(rays.reshape((h * w,)), appearance_mode="index")
        gt = torch.from_numpy(load_rgb(f)).to(dev).float() / 255.0
        psnr.append(float(psnr_fn(out["rgb"].reshape(h, w, 3), gt)))
        acc.append(float(out["accumulation"].mean()))
    return psnr, acc


def phase_hash_train(torch, card: str, tmp: Path, ref: dict) -> None:
    """(c) The `signerf_nerfacto` train CLI with the hash backend on phase
    14c's grey-backdrop scene (its flags), HASH_TRAIN_STEPS steps: the
    step times, rays/s and peak memory of `phase_train`, then PSNR and
    accumulation of its 8 views beside 14c's factor NeRF, and both export
    subcommands on its checkpoint."""
    import dataclasses

    from signerf_tpu_torch import export
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.geometry.obj import load_obj
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    data = ref["data"]
    train = phase_train(torch, card, data, tmp, "signerf_nerfacto", HASH_TRAIN_STEPS, TRAIN_RAYS, 1,
                        expect_counts(), "14g(c)", extra=(*REFERENCE_FLAGS, *HASH_FLAG), label="hash_nerfacto")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    cfg = dataclasses.replace(NerfactoModelConfig(), background_color=REFERENCE_FLAGS[1], encoding_backend="hash")
    model = NerfactoModel(cfg, len(parsed.image_filenames))
    model.load_state_dict(load_checkpoint(latest_checkpoint(train["ckpt_dir"]))["params"], strict=True)
    zero_counts(ffc)
    t0 = time.perf_counter()
    psnr, acc = view_metrics(torch, model.to(torch.device("cuda")).eval(), parsed)
    views_s = time.perf_counter() - t0
    psnr_free, acc_free = view_metrics(torch, model, parsed, box=False)
    flags = ["--data", str(data), "--load-dir", str(train["ckpt_dir"]), "--device", "cuda",
             "--model.background-color", REFERENCE_FLAGS[1], "--model.encoding-backend", "hash"]
    t0 = time.perf_counter()
    rc_pc = export.main(["pointcloud", "--output", str(tmp / "hash.ply"), *flags])
    pc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_mesh = export.main(["mesh", "--output", str(tmp / "hash.obj"), "--resolution", str(EDIT_MESH_RESOLUTION),
                           "--iso", EDIT_MESH_ISO, *flags])
    mesh_s = time.perf_counter() - t0
    points = export.read_ply_header(tmp / "hash.ply") if rc_pc == 0 else 0
    verts, faces = load_obj(tmp / "hash.obj") if rc_mesh == 0 else ([], [])
    if sum(counts(ffc).values()) != 0 or points <= 0 or len(faces) == 0:
        fail(f"hash views and exports: launches {counts(ffc)}, {points} points, {len(faces)} faces")
    factor = NerfactoModel(dataclasses.replace(cfg, encoding_backend="factor"), len(parsed.image_filenames))
    factor.load_state_dict(load_checkpoint(latest_checkpoint(ref["ckpt_dir"]))["params"], strict=True)
    f_psnr_free, f_acc_free = view_metrics(torch, factor.to(torch.device("cuda")).eval(), parsed, box=False)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    fmt = lambda xs, f: ", ".join(f"{v:{f}}" for v in xs) + f" (mean {mean(xs):{f}})"  # noqa: E731
    print(f"phase 14g(c) hash signerf_nerfacto on 14c's scene: its {len(psnr)} views in {views_s:.3f} s; rays in "
          f"the scene box (as 14c): PSNR {fmt(psnr, '.2f')} dB, accumulation {fmt(acc, '.4f')}; 14c's factor NeRF: "
          f"PSNR {fmt(ref['psnr'], '.2f')}, accumulation {fmt(ref['accumulation'], '.4f')}; rays between the near "
          f"and far planes (as trained): hash PSNR {fmt(psnr_free, '.2f')}, accumulation {fmt(acc_free, '.4f')}; "
          f"factor PSNR {fmt(f_psnr_free, '.2f')}, accumulation {fmt(f_acc_free, '.4f')}; "
          f"export pointcloud {points} points in {pc_s:.3f} s, export mesh (resolution {EDIT_MESH_RESOLUTION}, "
          f"iso {EDIT_MESH_ISO}) {len(verts)} vertices, {len(faces)} faces in {mesh_s:.3f} s; K1 to K10 launches 0; "
          f"on {card}", flush=True)


def phase_hash_signerf(torch, card: str, data: Path, tmp: Path) -> None:
    """(d) The `signerf` train CLI with the hash backend, a few steps at
    16,384 rays (4 micro-batches, normals through autograd, second order),
    then one micro-batch of its checkpoint: finite normals, and the
    orientation loss alone reaches the base table."""
    import dataclasses

    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager
    from signerf_tpu_torch.data.pixel_samplers import sample_patches
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.models.signerf import SIGNeRFModel
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    out = tmp / "hash_signerf"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = cli.main(train_argv("signerf", data, out, HASH_SIGNERF_STEPS, "--steps-per-call", "1", *HASH_FLAG))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0 or sum(counts(ffc).values()) != 0:
        fail(f"hash signerf train CLI: rc {rc}, launches {counts(ffc)}")
    pipe = signerf_method().pipeline
    dm = SIGNeRFDataManager(dataclasses.replace(pipe.datamanager, dataparser=dataclasses.replace(
        pipe.datamanager.dataparser, data=data)), dev)
    model = SIGNeRFModel(dataclasses.replace(pipe.model, encoding_backend="hash", use_lpips=False), dm.num_images)
    model.load_state_dict(load_checkpoint(latest_checkpoint(out / "experiment" / "signerf" / "checkpoints"))["params"],
                          strict=True)
    model = model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = sample_patches(gen, SIGNERF_RAYS // SIGNERF_MICRO, 32, dm.num_images, dm.cameras.height, dm.cameras.width)
    out_mb = model(dm.cameras.generate_rays_at(idx), None, train=True, anneal=1.0)
    for key in ("normals_samples", "normals", "pred_normals"):
        if not bool(torch.isfinite(out_mb[key]).all()):
            fail(f"hash signerf: non-finite {key}")
    model.zero_grad()
    model.normals_losses(out_mb)["orientation_loss"].backward()
    g = model.field.encoding.table.grad
    if g is None or not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
        fail("hash signerf: the orientation loss gives no finite, nonzero base-table gradient")
    print(f"phase 14g(d) signerf train CLI with the hash backend: {HASH_SIGNERF_STEPS} steps of {SIGNERF_RAYS} rays "
          f"({SIGNERF_MICRO} micro-batches, gradient normals by autograd through the hash encode, kept "
          f"differentiable) exit 0 in {wall:.3f} s, peak memory {peak:.3f} GiB, K1 to K10 launches 0; one micro-batch "
          f"of its checkpoint: normals finite, orientation-loss gradient in the base table norm "
          f"{float(g.norm()):.4g} over {int((g != 0).any(-1).sum())} of {g.shape[0] * g.shape[1]} rows; on {card}",
          flush=True)


def phase_hash_repeat(torch, card: str, tmp: Path, ref: dict) -> None:
    """The spread between two identical training runs: the hash
    `signerf_nerfacto` twice from the same seed, HASH_REPEAT_STEPS steps,
    each step's loss recorded; index_add_'s atomics in the table gradient
    make the sums' order differ between runs."""
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.engine import train_step as tts

    real_loss = tts.default_loss_fn
    runs = []
    for run in range(2):
        losses = []

        def recording_loss(model, outputs, batch):
            total, ld = real_loss(model, outputs, batch)
            losses.append(total.detach())
            return total, ld

        tts.default_loss_fn = recording_loss
        try:
            rc = cli.main(train_argv("signerf_nerfacto", ref["data"], tmp / f"hash_repeat{run}", HASH_REPEAT_STEPS,
                                     "--steps-per-call", "1", *REFERENCE_FLAGS, *HASH_FLAG))
        finally:
            tts.default_loss_fn = real_loss
        if rc != 0 or len(losses) != HASH_REPEAT_STEPS:
            fail(f"hash repeat run {run}: rc {rc}, {len(losses)} losses")
        runs.append([float(v) for v in losses])
    deltas = [abs(a - b) for a, b in zip(*runs)]
    rel = [d / abs(a) for d, a in zip(deltas, runs[0])]
    print(f"phase 14g run-to-run: hash signerf_nerfacto twice from seed 42, {HASH_REPEAT_STEPS} steps of "
          f"{TRAIN_RAYS} rays on 14c's scene: per-step |d loss| " + ", ".join(f"{d:.3e}" for d in deltas)
          + " (relative " + ", ".join(f"{r:.2e}" for r in rel) + f"); losses of run 0 "
          + ", ".join(f"{v:.6f}" for v in runs[0]) + f"; on {card}", flush=True)
    if not all(d == d for d in deltas):
        fail("hash repeat: a loss is NaN")


def phase_hash(torch, card: str, data: Path, tmp: Path, ref: dict) -> None:
    """Phase 14g, the hash backend: (a) to (d) and the run-to-run spread."""
    t0 = time.perf_counter()
    phase_hash_encode(torch, card)
    phase_hash_render(torch, card, data, tmp)
    phase_hash_train(torch, card, tmp, ref)
    phase_hash_signerf(torch, card, data, tmp)
    phase_hash_repeat(torch, card, tmp, ref)
    print(f"phase 14g wall {time.perf_counter() - t0:.1f} s; on {card}", flush=True)


# K7 and the SDXL inpaint. The 3x3 sheet of 512 px cells (1536 px square)
# is the JAX package's production regime: a latent of 192^2, so the UNet's
# self-attention runs at S = 9216 with 10 heads (block 1) and S = 2304 with
# 20 heads (block 2); per CFG branch 14 calls at S = 9216 (UNet 10,
# ControlNet 4) and 90 at S = 2304 (UNet 60, ControlNet 30).
SHEET_CELL = 512
SHEET_GRID = 3
K7_SHEET_CALLS = {(1, 9216, 10): 14, (1, 2304, 20): 90}  # per CFG branch
K7_PER_STEP = 2 * sum(K7_SHEET_CALLS.values())  # sequential CFG: two branches
K7_SHAPES = [(1, 9216, 10), (1, 2304, 20), (2, 2304, 20), (1, 4096, 10), (1, 1000, 10), (3, 77, 2), (1, 1, 1)]
K7_TIMED_FROM = 384  # sequence lengths from here on are timed against SDPA and the bound
# K7 vs its twin: the twin rounds the scores to bf16 (and scales in bf16),
# K7 keeps them in f32, so they differ by that rounding: 1e-2 of the norm.
# K7 vs an f32 reference (q, k, v upcast): bf16 P and output rounding only,
# 5e-3 of the norm, and K7 must be the closer of the two.
K7_TWIN_TOL = 1e-2
K7_REF_TOL = 5e-3
# One CFG branch at the sheet shape (UNet + ControlNet, random weights),
# K7 vs the twin in all 104 self-attentions: the bf16 score rounding of
# the twin moves each attention output by ~5e-3 of its norm, and 60 layers
# carry it to eps.
CFG_BRANCH_TOL = 0.1
PER_VIEW_STEPS = 5  # the per-view phase's num_inference_steps: 4 sampler steps at strength 0.9


def k7_bound(b: int, s: int, h: int):
    return bound(4 * b * s * h * 64 * 2, 4 * b * h * s * s * 64)


def phase_k7(torch, card: str) -> dict:
    """K7 against its plain twin and an f32 reference at the sheet's and a
    1024 px view's shapes and at ragged ones; CUDA-event times of the
    kernel, the twin and one scaled_dot_product_attention call."""
    from signerf_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    stats = {"max_abs_err": 0.0}
    per_shape = {}
    for b, s, h in dict.fromkeys((*K7_SHAPES, *K7_EDIT_SHAPES, *K7_TP_SHAPES, *K7_TP_EDIT_SHAPES, *K7_PASS_SHAPES)):
        q, k, v = (torch.randn(b, s, h, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v, 0.125)
        torch.cuda.synchronize()
        twin = fa.flash_attention_plain(q, k, v, 0.125)
        qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
        ref = (torch.softmax(qf @ kf.transpose(-1, -2) * 0.125, -1) @ vf).transpose(1, 2).reshape(b, s, h * 64)
        del qf, kf, vf
        e_twin, e_ref, e_twin_ref = rel_err(got, twin), rel_err(got, ref), rel_err(twin, ref)
        if not bool(torch.isfinite(got).all()) or e_twin > K7_TWIN_TOL or e_ref > K7_REF_TOL or e_ref > e_twin_ref:
            fail(f"K7 (B, S, H) = {(b, s, h)}: norm-rel err vs twin {e_twin:.3g} (bound {K7_TWIN_TOL}), vs f32 "
                 f"{e_ref:.3g} (bound {K7_REF_TOL}), twin vs f32 {e_twin_ref:.3g}")
        stats["max_abs_err"] = max(stats["max_abs_err"], float((got.float() - twin.float()).abs().max()))
        line = (f"phase 15 K7 (B, S, H) = {(b, s, h)}: norm-rel err vs twin {e_twin:.3e}, vs f32 reference "
                f"{e_ref:.3e} (twin vs f32 {e_twin_ref:.3e})")
        del got, twin, ref
        if s >= K7_TIMED_FROM or (b, s, h) in K7_TP_SHAPES + K7_TP_EDIT_SHAPES + K7_PASS_SHAPES:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=0.125)  # noqa: E731
            lib1 = cuda_ms(sdpa, 20)
            k_ms, p_ms = twin_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, 0.125),
                                 lambda: fa.flash_attention_plain(q, k, v, 0.125))
            lib_ms = (lib1 + cuda_ms(sdpa, 20)) / 2
            b_ms, b_by = k7_bound(b, s, h)
            per_shape[(b, s, h)] = (k_ms, p_ms, lib_ms, b_ms, b_by)
            line += (f"; kernel {k_ms:.4f} ms ({4 * b * h * s * s * 64 / k_ms / 1e9:.1f} TFLOP/s), twin {p_ms:.4f} ms, "
                     f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                     f"{b_ms / k_ms:.1%} of it)")
        print(line, flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for (b, s, h) in (*K7_SHEET_CALLS, *K7_EDIT_SHAPES, *tp_shapes(K7_SHEET_CALLS)):
        k_ms, _, lib_ms, b_ms, b_by = per_shape[(b, s, h)]
        which = ("sheet" if (b, s, h) in K7_SHEET_CALLS else "edit pass" if (b, s, h) in K7_EDIT_SHAPES
                 else f"TP-{TP} sheet (a rank's heads)")
        print(f"phase 15 K7 vs scaled_dot_product_attention at the {which} shape (B, S, H) = {(b, s, h)}: kernel "
              f"{k_ms:.4f} ms, SDPA {lib_ms:.4f} ms, ratio {k_ms / lib_ms:.3f}, "
              f"{4 * b * h * s * s * 64 / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.1%} of its bound ({b_ms:.4f} ms, "
              f"{b_by}); on {card}", flush=True)
    for key, i in (("ms", 0), ("plain_ms", 1), ("library_ms", 2), ("bound_ms", 3)):
        stats[key] = 2 * sum(n * per_shape[shape][i] for shape, n in K7_SHEET_CALLS.items())
    stats["bound_by"] = per_shape[(1, 9216, 10)][4]
    print(f"phase 15 K7 per sampler step of the sheet inpaint ({K7_PER_STEP} calls): kernel {stats['ms']:.3f} ms, "
          f"twin {stats['plain_ms']:.3f} ms, scaled_dot_product_attention {stats['library_ms']:.3f} ms, bound "
          f"{stats['bound_ms']:.3f} ms; on {card}", flush=True)
    stats["per_shape"] = {shape: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), v))
                          for shape, v in per_shape.items()}
    return stats


def step_stats(pipe) -> tuple:
    ev = pipe.last_run["step_events"]
    ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1))
    return ms[len(ms) // 2], ms[0], ms[-1]


def phase_sheet(torch, card: str, ref: dict) -> dict:
    """The full SDXL + ControlNet-depth stack at random init in bf16 on the
    card, then `Diffuser.diffuse` at the defaults on phase 14c's 1536 px
    reference sheet, blended with its mask and split into its cells."""
    import warnings

    import numpy as np

    from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
    from signerf_tpu_torch.diffusion.layers import count_params
    from signerf_tpu_torch.editing.sheet import blend_with_mask, split_cells
    from signerf_tpu_torch.ops import flash_attention as fa
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    diffuser = Diffuser(DiffuserConfig())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = diffuser.pipeline
    if not any("RANDOM-INIT" in str(w.message) for w in caught):
        fail("SDXL ran at random init without the uncalibrated warning")
    sizes = {name: count_params(getattr(pipe, name)) for name in ("unet", "controlnet", "vae", "clip_l", "clip_g")}
    n_params, n_bytes = sum(v[0] for v in sizes.values()), sum(v[1] for v in sizes.values())
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 16 SDXL create on the card (random init, bf16, built on the meta device): {n_params / 1e9:.3f} B "
          f"parameters, {n_bytes / 1e9:.3f} GB (" + ", ".join(f"{k} {v[0] / 1e9:.3f} B" for k, v in sizes.items())
          + f"), {pipe.init_seconds:.2f} s, peak memory {init_peak:.2f} GiB, uncalibrated warning printed",
          flush=True)

    sheet, mask, depth = (ref[k].cpu().numpy() for k in ("image_sheet", "mask_sheet", "cond_sheet"))
    cfg = diffuser.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    zero_counts(ffc)
    t0 = time.perf_counter()
    out = diffuser.diffuse(sheet, sheet, mask, depth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    run_info = pipe.last_run
    steps = run_info["sampler_steps"]
    if steps != int(cfg.denoising_strength * cfg.num_inference_steps):
        fail(f"the sheet inpaint ran {steps} sampler steps")
    if not run_info["sequential_cfg"]:
        fail("sequential CFG did not engage at the 1536 px sheet")
    if launches != K7_PER_STEP * steps:
        fail(f"K7 launched {launches} times in the sheet inpaint, expected {K7_PER_STEP} x {steps}")
    if any(counts(ffc).values()):
        fail(f"the sheet inpaint launched factor-grid kernels: {counts(ffc)}")
    if out.shape != sheet.shape or not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        fail(f"sheet output: shape {out.shape}, finite {np.isfinite(out).all()}, range {out.min()} to {out.max()}")
    edited = blend_with_mask(torch.from_numpy(out).to(ref["image_sheet"].device), ref["image_sheet"], ref["mask_sheet"])
    cells = split_cells(ref["layout"], edited, ref["count"])
    if len(cells) != ref["count"] or any(tuple(c.shape) != (SHEET_CELL, SHEET_CELL, 3) for c in cells):
        fail(f"split_cells gave {[tuple(c.shape) for c in cells]}")
    if not bool(torch.isfinite(edited).all()) or float(edited.min()) < 0.0 or float(edited.max()) > 1.0:
        fail("the blended sheet is not finite or outside [0, 1]")
    outside = float((edited - ref["image_sheet"]).abs().mul(1.0 - ref["mask_sheet"]).max())
    if outside != 0.0:
        fail(f"the blend changed pixels outside the mask by up to {outside}")
    med, lo, hi = step_stats(pipe)
    print(f"phase 16 Diffuser.diffuse at the defaults ({cfg.num_inference_steps} steps, strength "
          f"{cfg.denoising_strength}, CFG {cfg.guidance_scale}, ControlNet {cfg.controlnet_conditioning_scale}, "
          f"Euler a, mask_blur {cfg.mask_blur}, fill {cfg.inpainting_fill}) on phase 14c's {sheet.shape[1]}x"
          f"{sheet.shape[0]} {SHEET_GRID}x{SHEET_GRID} reference sheet of {SHEET_CELL} px cells: sequential CFG "
          f"engaged, {steps} sampler steps, "
          f"K7 launches {launches} (= {K7_PER_STEP} x {steps}), other kernels 0; wall {wall:.3f} s; sampler step "
          f"median {med:.2f} ms (range {lo:.2f} to {hi:.2f}) = {steps * med / 1e3:.3f} s of the wall; peak memory "
          f"{peak:.2f} GiB; output {out.shape} in [{out.min():.3f}, {out.max():.3f}], finite; blended with the mask "
          f"(unchanged outside it) and split into {len(cells)} cells of {SHEET_CELL} px; on {card}", flush=True)
    return {"diffuser": diffuser, "sheet": sheet, "mask": mask, "depth": depth, "ref": ref,
            "launches": launches, "steps": steps, "wall": wall, "step_ms": med, "peak_gib": peak}


def phase_per_view(torch, card: str, sh: dict) -> int:
    """The per-view fast path: the sheet's encoder features cached once,
    then phase 14c's dataset view 3 spliced into the last cell through the
    windowed encode and decode."""
    import dataclasses

    import numpy as np

    from signerf_tpu_torch.diffusion.diffuser import Diffuser
    from signerf_tpu_torch.editing.sheet import splice_last_cell
    from signerf_tpu_torch.ops import flash_attention as fa

    base = sh["diffuser"]
    view = Diffuser(dataclasses.replace(base.config, num_inference_steps=PER_VIEW_STEPS), pipeline=base.pipeline)
    t0 = time.perf_counter()
    cache = view.prepare_sheet_cache(sh["sheet"], (SHEET_CELL, SHEET_CELL))
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    ref = sh["ref"]
    sheet, mask, cond = (t.cpu().numpy() for t in splice_last_cell(ref["layout"], ref["image_sheet"],
                                                                     ref["cond_sheet"], *ref["target"]))
    fa.launches = 0
    t0 = time.perf_counter()
    win = view.diffuse(sheet, sheet, mask, cond, sheet_cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pipe = base.pipeline
    steps = pipe.last_run["sampler_steps"]
    dec_h, dec_w = cache.window_lat[4:]
    f = pipe.config.vae_downscale
    if not pipe.last_run["windowed"] or win.shape != (dec_h * f, dec_w * f, 3):
        fail(f"per-view call: windowed {pipe.last_run['windowed']}, shape {win.shape}")
    if not np.isfinite(win).all() or fa.launches != K7_PER_STEP * steps:
        fail(f"per-view call: finite {np.isfinite(win).all()}, K7 launches {fa.launches} for {steps} steps")
    med, lo, hi = step_stats(pipe)
    print(f"phase 17 per-view fast path: prepare_sheet_cache {cache_s:.3f} s (window_lat {cache.window_lat}); "
          f"diffuse(sheet_cache=...) with num_inference_steps {PER_VIEW_STEPS} (cut from 20: {steps} sampler steps) "
          f"returned the {win.shape} window, K7 launches {fa.launches} (= {K7_PER_STEP} x {steps}), wall {wall:.3f} s, "
          f"sampler step median {med:.2f} ms (range {lo:.2f} to {hi:.2f}); on {card}", flush=True)
    return fa.launches


def cfg_branch(torch, pipe, sh: dict, seed: int = 9):
    """One CFG branch's eps at the sheet shape (ControlNet, then the UNet
    with its residuals scaled by 0.8), as the pipeline runs it."""
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    f = pipe.config.vae_downscale
    h, w = sh["sheet"].shape[:2]
    x = torch.randn(1, h // f, w // f, 4, generator=g, device=dev) * 0.2
    cond = torch.as_tensor(sh["depth"], device=dev).repeat_interleave(3, -1)[None]
    t = torch.full((1,), 500.0, device=dev)
    ctx, pooled = pipe.encode_prompt("don't change the image", "")
    tids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=dev)
    scale = torch.tensor(0.8, device=dev)

    def eps(branch: int):
        c, p = ctx[branch : branch + 1], pooled[branch : branch + 1]
        down, mid = pipe.controlnet(x, cond, t, c, p, tids)
        return pipe.unet(x, t, c, p, tids, [r.float() * scale for r in down], mid.float() * scale)

    return eps


def phase_cfg_branch(torch, card: str, sh: dict):
    """One CFG branch at the sheet shape through K7, then through the twin
    (`set_flash_attention(False)`). Returns the branch through K7 (phase
    24(a)'s one-rank reference)."""
    from signerf_tpu_torch.diffusion import unet as unet_mod
    from signerf_tpu_torch.ops import flash_attention as fa

    eps = cfg_branch(torch, sh["diffuser"].pipeline, sh)
    with torch.no_grad():
        fa.launches = 0
        e_k = eps(1)
        torch.cuda.synchronize()
        n = fa.launches
        unet_mod.set_flash_attention(False)
        try:
            e_p = eps(1)
            p_ms = cuda_ms(lambda: eps(1), 2)
        finally:
            unet_mod.set_flash_attention(True)
        k_ms = cuda_ms(lambda: eps(1), 2)
    err = rel_err(e_k, e_p)
    print(f"phase 18 one CFG branch at the sheet shape (ControlNet + UNet, latent {tuple(e_k.shape)}): K7 launches "
          f"{n}; eps through K7 vs through the twin: norm-rel {err:.3e} (bound {CFG_BRANCH_TOL}); branch "
          f"{k_ms:.2f} ms with K7, {p_ms:.2f} ms with the twin; on {card}", flush=True)
    if n != K7_PER_STEP // 2 or not bool(torch.isfinite(e_k).all()) or err > CFG_BRANCH_TOL:
        fail("the CFG branch through K7 and through the twin disagree, or K7 did not run in every self-attention")
    return e_k.float().cpu()


def phase_diffusion_profile(torch, card: str, sh: dict) -> None:
    """One sampler step's model work (both CFG branches) under torch.profiler:
    device busy share, K7's share of device time and the top kernels."""
    eps = cfg_branch(torch, sh["diffuser"].pipeline, sh)
    with torch.no_grad():
        plain_span = cuda_ms(lambda: (eps(0), eps(1)), 2)  # the same work, not profiled
        bd = kernel_breakdown(lambda: (eps(0), eps(1)), [("K7", ("flash_attention_kernel",))], warmup=0)
    span, busy, k7 = bd["span_ms"], bd["busy_ms"], bd["groups_ms"]["K7"]
    top = sorted(bd["kernels_ms"].items(), key=lambda kv: -kv[1])[:6]
    print(f"phase 19 profile of one sampler step's UNet + ControlNet work (2 CFG branches, sheet shape): span "
          f"{plain_span:.2f} ms unprofiled ({span:.2f} ms under the profiler), device busy {busy:.2f} ms "
          f"({busy / plain_span:.1%} of the unprofiled span, idle {1 - busy / plain_span:.1%}); K7 "
          f"{k7:.2f} ms ({k7 / busy:.1%} of device time); top kernels: "
          + "; ".join(f"{k[:70]} {v:.2f} ms ({v / busy:.1%})" for k, v in top) + f"; on {card}", flush=True)


# Phase 21, the JAX package's last modules and knobs in the port. (a)
# nerfstudio's linear proposal networks: each proposal field is the encode
# (K3 forward, K4's tables half backward) and one bf16 Dense, the base
# field stays on K1 / K2, so a train step launches K1 and K2's tables half
# once and K3 and K4's tables half twice.
LINEAR_ARGS = json.dumps([{"max_res": 128, "use_linear": True}, {"max_res": 256, "use_linear": True}])
LINEAR_FLAG = ("--pipeline.model.proposal-net-args-list", LINEAR_ARGS)
LINEAR_COUNTS = expect_counts(K1=1, K2_tables=1, K3=2, K4_tables=2)
PROPOSAL_FIELDS = [("proposal", 128, 256), ("prop256", 256, 96)]  # name, max_res, samples a ray
ARC_CAMERAS = 10
PLANE_DEFAULTS = dict(include_planes=True, plane_res=128, plane_features=8)  # the JAX config's defaults
REPEAT_STEPS = 10
CACHE = dict(size=4, every=2, fetches=5, seed=0)


def proposal_case(torch, max_res: int, n: int, gen, dev):
    """Proposal-field tables (5 levels of F = 8 to `max_res`), uniform
    coordinates and g [N, 40] on the card."""
    from signerf_tpu_torch.ops import factor_grid as fg

    cfg = fg.FactorGridConfig(num_levels=5, base_res=16, max_res=max_res, features_per_level=8)
    lines = [[torch.randn(r, 8, generator=gen) * 0.2 for _ in range(3)] for r in cfg.resolutions]
    x, g = torch.rand(n, 3, generator=gen), torch.randn(n, cfg.out_dim, generator=gen)
    return (cfg.resolutions, 8, fg.pack_tables(lines).to(dev), x.to(dev)), g.to(dev)


def phase_proposal_encode(torch) -> dict:
    """K3 (its proposal-field instantiation, new with the linear proposal
    networks) and K4's tables half against their twins at the sample counts
    of a 4096-ray train step and an 8192-ray render chunk of both proposal
    fields: error, times and bounds per call."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)
    out = {"max_abs_err": {"K3": 0.0, "K4 tables": 0.0}}
    line = ["phase 21(a) K3 and K4's tables half at the proposal fields, kernel vs plain twin:"]
    for name, max_res, samples in PROPOSAL_FIELDS:
        for where, rays in (("train", TRAIN_RAYS), ("chunk", CHUNK)):
            n = rays * samples
            args, g = proposal_case(torch, max_res, n, gen, dev)
            bounds = factor_bounds(args[0], args[1], args[2], n)
            calls = [("K3", lambda: ffc.encode_cuda(*args), lambda: ffc.encode_plain(*args))]
            if where == "train":
                calls.append(("K4 tables", lambda: ffc.encode_bwd_cuda(*args, g)[0],
                              lambda: ffc.encode_bwd_plain(*args, g)[0]))
            for k, kern, plain in calls:
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                if k == "K3":
                    err, tol = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12), K3_TOL
                else:
                    err, tol = rel_err(got, want), K456_TOL
                if err > tol or not bool(torch.isfinite(got).all()):
                    fail(f"{k} {name} {where} N={n}: error {err:.3g} > {tol}")
                out["max_abs_err"][k] = max(out["max_abs_err"][k], float((got - want).abs().max()))
                del got, want
                k_ms, p_ms = twin_ms(torch, kern, plain)
                b_ms, b_by = bounds[k]
                out[(k, name, where)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
                line.append(f"{k} {name} {where} N={n}: error {err:.2e}, {k_ms:.4f} vs {p_ms:.4f} ms (bound "
                            f"{b_ms:.4f} {b_by}, {b_ms / k_ms:.1%} of it);")
            del args, g
    torch.cuda.empty_cache()
    print(" ".join(line), flush=True)
    return out


def linear_config(torch):
    import dataclasses

    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig, ProposalNetArgs

    args = tuple(ProposalNetArgs(**a) for a in json.loads(LINEAR_ARGS))
    return dataclasses.replace(NerfactoModelConfig(), background_color=REFERENCE_FLAGS[1],
                               proposal_net_args_list=args)


def phase_linear_proposals(torch, card: str, tmp: Path, ref: dict, phase7: dict) -> dict:
    """(a) `signerf_nerfacto` with linear proposal networks through the
    train CLI on 14c's scene (phase 7's steps and rays), its 8 views' PSNR
    beside 14c's factor NeRF, and one 512 px frame through the render CLI."""
    import dataclasses

    from signerf_tpu_torch import render as render_cli
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    data = ref["data"]
    train = phase_train(torch, card, data, tmp, "signerf_nerfacto", TRAIN_STEPS, TRAIN_RAYS, 1, LINEAR_COUNTS,
                        "21(a)", extra=(*REFERENCE_FLAGS, *LINEAR_FLAG), label="linear_nerfacto")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    model = NerfactoModel(linear_config(torch), len(parsed.image_filenames))
    model.load_state_dict(load_checkpoint(latest_checkpoint(train["ckpt_dir"]))["params"], strict=True)
    if any(".MLP_0." in k for k in model.state_dict()):
        fail("linear proposal networks with an MLP_0")
    chunks = -(-(SCENE["width"] * SCENE["height"]) // CHUNK)
    zero_counts(ffc)
    psnr, acc = view_metrics(torch, model.to(torch.device("cuda")).eval(), parsed)
    torch.cuda.synchronize()
    views = len(psnr)
    if counts(ffc) != expect_counts(K1=chunks, K3=2 * chunks)(views):
        fail(f"linear proposals, {views} views: launches {counts(ffc)}, expected K1 {chunks} and K3 "
             f"{2 * chunks} a view")
    psnr_free, acc_free = view_metrics(torch, model, parsed, box=False)
    factor = NerfactoModel(dataclasses.replace(NerfactoModelConfig(), background_color=REFERENCE_FLAGS[1]),
                           len(parsed.image_filenames))
    factor.load_state_dict(load_checkpoint(latest_checkpoint(ref["ckpt_dir"]))["params"], strict=True)
    f_psnr_free, f_acc_free = view_metrics(torch, factor.to(torch.device("cuda")).eval(), parsed, box=False)
    zero_counts(ffc)
    out = tmp / "linear_render"
    zero_counts(ffc)
    t0 = time.perf_counter()
    rc = render_cli.main(["--data", str(data), "--output", str(out), "--load-dir", str(train["ckpt_dir"]), "--arc",
                          "1", "--device", "cuda", "--mesh", "none", "--depth", "false", "--model.background-color",
                          REFERENCE_FLAGS[1], "--model.proposal-net-args-list", LINEAR_ARGS])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    render = counts(ffc)
    if rc != 0 or render != expect_counts(K1=chunks, K3=2 * chunks)(1) or not (out / "rgb_00000.png").exists():
        fail(f"render CLI with linear proposals: rc {rc}, launches {render}")
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    print(f"phase 21(a) linear proposal networks on 14c's scene: train rays/s {train['rays_per_s']:.0f} (phase 7, "
          f"nerfacto's MLP proposals on the white scene: {phase7['rays_per_s']:.0f}); its {views} views in the scene "
          f"box: PSNR " + ", ".join(f"{v:.2f}" for v in psnr) + f" (mean {mean(psnr):.2f}) dB, accumulation mean "
          f"{mean(acc):.4f}; 14c's factor NeRF with MLP proposals: PSNR mean {mean(ref['psnr']):.2f} dB, "
          f"accumulation mean {mean(ref['accumulation']):.4f}; rays between the near and far planes (as trained): "
          f"linear PSNR mean {mean(psnr_free):.2f} dB, accumulation mean {mean(acc_free):.4f}, 14c's NeRF "
          f"{mean(f_psnr_free):.2f} dB, {mean(f_acc_free):.4f}; views launched K1 {chunks} and K3 {2 * chunks} a "
          f"view, no other kernel; render CLI, one {SCENE['width']} px frame: K1 {render['K1']}, K3 {render['K3']}, "
          f"wall {cli_s:.3f} s; on {card}", flush=True)
    return {"train": train, "views": views, "chunks": chunks, "render_frames": 1}


def phase_camera_arc(torch, card: str, data: Path, ckpt_dir: Path) -> dict:
    """(b) `CameraArcDataset` cameras around the scene, phase 7's checkpoint
    rendered over `FixedIndicesEvalCameraDataloader`."""
    from signerf_tpu_torch.data.camera_arc import (
        CameraArcDataset,
        CameraArcDatasetConfig,
        FixedIndicesEvalCameraDataloader,
    )
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    model = NerfactoModel(NerfactoModelConfig(), len(parsed.image_filenames))
    model.load_state_dict(load_checkpoint(latest_checkpoint(ckpt_dir))["params"], strict=True)
    model = model.to(dev).eval()
    w, h = SCENE["width"], SCENE["height"]
    # the render CLI's arc: radius 1 in the NeRF's frame, the dataset's focal
    fx = float(parsed.cameras.fx[0])
    arc = CameraArcDataset(CameraArcDatasetConfig(num_cameras=ARC_CAMERAS, radius=1.0, theta=70.0, width=w,
                                                  height=h, fx=fx, fy=fx))
    if arc.cameras.device.type != "cuda":
        fail("CameraArcDataset did not put its cameras on the card")
    loader = FixedIndicesEvalCameraDataloader(arc.cameras, range(ARC_CAMERAS), torch.as_tensor(parsed.scene_box_aabb))
    render = make_eval_render(model, chunk_size=CHUNK)
    chunks = -(-(w * h) // CHUNK)
    frame_ms, acc, order = [], [], []
    torch.cuda.synchronize()
    zero_counts(ffc)
    for i, bundle in loader:
        t0 = time.perf_counter()
        out = render(bundle.reshape((h * w,)))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        order.append(i)
        for k, v in out.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"camera arc view {i}: non-finite {k}")
        acc.append(float(out["accumulation"].mean()))
    got = counts(ffc)
    if got != expect_counts(K1=3 * chunks)(ARC_CAMERAS) or order != list(range(ARC_CAMERAS)):
        fail(f"camera arc: launches {got}, expected K1 3 x {chunks} x {ARC_CAMERAS}; order {order}")
    if not min(acc) > 0.0:
        fail(f"camera arc: a view's accumulation is {min(acc)}")
    warm = sorted(frame_ms[1:])
    print(f"phase 21(b) CameraArcDataset, {ARC_CAMERAS} cameras at {w}x{h} (radius 1, theta 70, fx {fx:.1f}), phase "
          f"7's checkpoint over FixedIndicesEvalCameraDataloader: K1 {got['K1']} (= 3 x {chunks} x {ARC_CAMERAS}), "
          f"no other kernel; frame median {warm[len(warm) // 2]:.3f} ms (range {warm[0]:.3f} to {warm[-1]:.3f}, "
          f"first {frame_ms[0]:.3f}); outputs finite, mean accumulation " + ", ".join(f"{a:.2e}" for a in acc)
          + f"; on {card}", flush=True)
    return {"chunks": chunks * ARC_CAMERAS}


def base_encoding(torch, ckpt_dir: Path, **knobs):
    """A `FactorGridEncoding` at the base field's schedule (with `knobs`)
    holding the line tables of the checkpoint in `ckpt_dir`, on the card."""
    from signerf_tpu_torch.engine.checkpoints import latest_checkpoint, load_checkpoint
    from signerf_tpu_torch.models.fields import FactorGridEncoding
    from signerf_tpu_torch.ops.factor_grid import FactorGridConfig

    levels, max_res, feat = BASE_SCHEDULE
    enc = FactorGridEncoding(FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res,
                                              features_per_level=feat, **knobs))
    enc.reset_parameters(torch.Generator().manual_seed(21))
    params = load_checkpoint(latest_checkpoint(ckpt_dir))["params"]
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.startswith("line_"):
                p.copy_(params[f"field.encoding.{name}"])
    return enc.to(torch.device("cuda"))


def phase_planes(torch, card: str, ckpt_dir: Path) -> dict:
    """(c) `FactorGridEncoding` with planes (the JAX defaults) on phase 7's
    base-field lines at one `signerf` micro-batch's N, forward and backward,
    against the same module on the twins."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    enc = base_encoding(torch, ckpt_dir, **PLANE_DEFAULTS)
    gen = torch.Generator().manual_seed(22)
    n = SIGNERF_SAMPLES
    x = torch.rand(n, 3, generator=gen).to(dev)
    ct = torch.randn(n, enc.out_dim, generator=gen).to(dev)

    def run():
        enc.zero_grad()
        out = enc(x)
        (out * ct).sum().backward()
        return out.detach(), {k: p.grad.clone() for k, p in enc.named_parameters()}

    torch.cuda.synchronize()
    zero_counts(ffc)
    got, g_got = run()
    torch.cuda.synchronize()
    launched = counts(ffc)
    if launched != expect_counts(K3=1, K4_tables=1)(1):
        fail(f"planes: launches {launched}, expected K3 1 and K4 tables 1")
    want, g_want = with_twins(ffc, ("encode", "encode_bwd"), run)
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
    if err > 2**-8 or not bool(torch.isfinite(got).all()) or tuple(got.shape) != (n, enc.out_dim):
        fail(f"planes: features {tuple(got.shape)}, error {err:.3g} of max|ref| > 2^-8")
    errs = {k: rel_err(g_got[k], g_want[k]) for k in g_got}
    worst = max(errs, key=errs.get)
    if errs[worst] > K456_TOL:
        fail(f"planes: {worst}'s gradient {errs[worst]:.3g} from the twin's > {K456_TOL}")
    fwd_ms = cuda_ms(lambda: enc(x), 5)
    step_ms = cuda_ms(run, 5)
    twin_ms_ = with_twins(ffc, ("encode", "encode_bwd"), lambda: cuda_ms(run, 2))
    print(f"phase 21(c) FactorGridEncoding with planes (plane_res {PLANE_DEFAULTS['plane_res']}, plane_features "
          f"{PLANE_DEFAULTS['plane_features']}, D = {enc.out_dim}) on phase 7's base-field lines, N={n}: launches K3 "
          f"{launched['K3']}, K4 tables {launched['K4 tables']}, no other kernel; features {err:.2e} of max|ref| from "
          f"the twins', worst gradient {worst} {errs[worst]:.2e} norm-relative (lines and planes; bound {K456_TOL}); "
          f"forward {fwd_ms:.3f} ms, forward + backward {step_ms:.3f} ms (on the twins {twin_ms_:.3f} ms); on {card}",
          flush=True)
    return {"K3": 1, "K4 tables": 1}


def phase_encode_with_grad(torch, card: str, ckpt_dir: Path) -> dict:
    """(d) `FactorGridEncoding.encode_with_grad` on phase 7's base-field
    lines at the same N, values and the VJP w.r.t. the lines, against the
    same calls on the twins."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    enc = base_encoding(torch, ckpt_dir)
    gen = torch.Generator().manual_seed(23)
    n, d = SIGNERF_SAMPLES, enc.out_dim
    x = torch.rand(n, 3, generator=gen).to(dev)
    ct_f, ct_d = torch.randn(n, d, generator=gen).to(dev), torch.randn(n, 3, d, generator=gen).to(dev)

    def run():
        enc.zero_grad()
        f, df = enc.encode_with_grad(x)
        ((f * ct_f).sum() + (df * ct_d).sum()).backward()
        return f.detach(), df.detach(), {k: p.grad.clone() for k, p in enc.named_parameters()}

    torch.cuda.synchronize()
    zero_counts(ffc)
    f, df, g = run()
    torch.cuda.synchronize()
    launched = counts(ffc)
    expected = expect_counts(K3=1, K4_tables=1, K8=1, K9_tables=1)(1)
    if launched != expected:
        fail(f"encode_with_grad: launches {launched}, expected {expected}")
    twins = ("encode", "encode_bwd", "grad", "grad_bwd")
    f_w, df_w, g_w = with_twins(ffc, twins, run)
    e_f = float((f - f_w).abs().max()) / max(float(f_w.abs().max()), 1e-12)
    e_d = rel_err(df, df_w)
    errs = {k: rel_err(g[k], g_w[k]) for k in g}
    worst = max(errs, key=errs.get)
    if e_f > K3_TOL or e_d > K456_TOL or errs[worst] > K456_TOL or not bool(torch.isfinite(df).all()):
        fail(f"encode_with_grad vs the twins: features {e_f:.3g}, d features {e_d:.3g}, {worst} {errs[worst]:.3g}")
    fwd_ms = cuda_ms(lambda: enc.encode_with_grad(x), 5)
    step_ms = cuda_ms(run, 5)
    print(f"phase 21(d) encode_with_grad on phase 7's base-field lines, N={n}: launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items() if v) + f", no other kernel; vs the twins: features "
          f"{e_f:.2e} of max|ref|, d features {e_d:.2e}, worst line gradient {worst} {errs[worst]:.2e} "
          f"(norm-relative); forward {fwd_ms:.3f} ms, forward + VJP {step_ms:.3f} ms; on {card}", flush=True)
    return launched


def phase_image_cache(torch, card: str, data: Path) -> None:
    """(g) `CachedImageStore` on the card over the scene's images."""
    import numpy as np

    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.data.datamanager import CachedImageStore, load_images

    parsed = parse_transforms(SIGNeRFDataParserConfig(data=data))
    files, w, h = parsed.image_filenames, SCENE["width"], SCENE["height"]
    full = torch.from_numpy(load_images(files, w, h)).cuda()
    t0 = time.perf_counter()
    store = CachedImageStore(files, w, h, CACHE["size"], CACHE["every"], seed=CACHE["seed"])
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(CACHE["seed"])
    want = rng.choice(len(files), CACHE["size"], replace=False)
    subsets, fetch_ms = [], []
    for k in range(1, CACHE["fetches"] + 1):
        if k % CACHE["every"] == 0:
            want = rng.choice(len(files), CACHE["size"], replace=False)
        t0 = time.perf_counter()
        images, idx = store.fetch()
        torch.cuda.synchronize()
        fetch_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(idx, want) or images.device.type != "cuda" or images.dtype != torch.uint8:
            fail(f"CachedImageStore fetch {k}: indices {idx.tolist()} on {images.device}, numpy's {want.tolist()}")
        if not torch.equal(images, full[torch.as_tensor(idx, device=full.device)]):
            fail(f"CachedImageStore fetch {k}: rows differ from the full stack's")
        subsets.append(idx.tolist())
    print(f"phase 21(g) CachedImageStore, {CACHE['size']} of {len(files)} images of {w}x{h} on the card, resampled "
          f"every {CACHE['every']} fetches: subsets " + ", ".join(map(str, subsets)) + " equal numpy's RandomState("
          f"{CACHE['seed']}) draws, rows equal the full stack's; build {build_s * 1e3:.1f} ms, fetches "
          + ", ".join(f"{v:.1f}" for v in fetch_ms) + f" ms; on {card}", flush=True)


def phase_flops(torch, card: str, phase7: dict, linear: dict) -> None:
    """(h) The FLOP model: per-ray counts of phase 7's model and (a)'s,
    their tensor-core and CUDA-core shares at the measured train rays/s."""
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
    from signerf_tpu_torch.ops import flops

    for label, cfg, rays in (("phase 7 (MLP proposals)", NerfactoModelConfig(), phase7["rays_per_s"]),
                             ("21(a) (linear proposals)", linear_config(torch), linear["train"]["rays_per_s"])):
        f = flops.nerfacto_flops(cfg)
        tc = flops.utilization(f.train_tc_per_ray, rays, flops.BF16_FLOP_PER_S)
        cc = flops.utilization(f.train_f32_per_ray, rays, flops.F32_FLOP_PER_S)
        print(f"phase 21(h) FLOP model, {label}: render {f.render_per_ray / 1e6:.3f} MFLOP a ray "
              f"(tensor cores {f.render_tc_per_ray / 1e6:.3f}, f32 {f.render_f32_per_ray / 1e6:.3f}); train "
              f"{f.train_per_ray / 1e6:.3f} MFLOP a ray (tensor cores {f.train_tc_per_ray / 1e6:.3f}, f32 "
              f"{f.train_f32_per_ray / 1e6:.3f}); at {rays:.0f} train rays/s: tensor cores {tc:.3f}% of "
              f"{flops.BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, CUDA cores {cc:.3f}% of "
              f"{flops.F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; breakdown: "
              + "; ".join(r.strip() for r in flops.breakdown_str(f).split("\n")) + f"; on {card}", flush=True)


def phase_factor_repeat(torch, card: str, tmp: Path, ref: dict) -> None:
    """The spread between two identical factor training runs (ROADMAP
    Queue 3): `signerf_nerfacto` twice from seed 42 on 14c's scene, each
    step's loss recorded, as 14g's check does for the hash backend."""
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    real_loss = tts.default_loss_fn
    runs = []
    for run in range(2):
        losses = []

        def recording_loss(model, outputs, batch):
            total, ld = real_loss(model, outputs, batch)
            losses.append(total.detach())
            return total, ld

        tts.default_loss_fn = recording_loss
        zero_counts(ffc)
        try:
            rc = cli.main(train_argv("signerf_nerfacto", ref["data"], tmp / f"factor_repeat{run}", REPEAT_STEPS,
                                     "--steps-per-call", "1", *REFERENCE_FLAGS))
        finally:
            tts.default_loss_fn = real_loss
        torch.cuda.synchronize()
        if rc != 0 or len(losses) != REPEAT_STEPS or counts(ffc) != NERFACTO_COUNTS(REPEAT_STEPS):
            fail(f"factor repeat run {run}: rc {rc}, {len(losses)} losses, launches {counts(ffc)}")
        runs.append([float(v) for v in losses])
    deltas = [abs(a - b) for a, b in zip(*runs)]
    rel = [d / abs(a) for d, a in zip(deltas, runs[0])]
    same = next((i for i, d in enumerate(deltas) if d != 0.0), REPEAT_STEPS)
    print(f"phase 21 run-to-run (factor): signerf_nerfacto twice from seed 42, {REPEAT_STEPS} steps of {TRAIN_RAYS} "
          f"rays on 14c's scene ({' '.join(REFERENCE_FLAGS)}; K1, K2 tables 3 a step): the loss equal bit for bit "
          f"for the first {same} step(s); per-step |d loss| " + ", ".join(f"{d:.3e}" for d in deltas) + " (relative "
          + ", ".join(f"{r:.2e}" for r in rel) + "); losses of run 0 " + ", ".join(f"{v:.6f}" for v in runs[0])
          + f"; on {card}", flush=True)
    if not all(d == d for d in deltas):
        fail("factor repeat: a loss is NaN")


def phase_last_modules(torch, card: str, data: Path, tmp: Path, ref: dict, phase7: dict) -> dict:
    """Phase 21 (a) to (d), (g), (h) and the factor run-to-run check."""
    t0 = time.perf_counter()
    stats = phase_proposal_encode(torch)
    linear = phase_linear_proposals(torch, card, tmp, ref, phase7)
    arc = phase_camera_arc(torch, card, data, phase7["ckpt_dir"])
    planes = phase_planes(torch, card, phase7["ckpt_dir"])
    ewg = phase_encode_with_grad(torch, card, phase7["ckpt_dir"])
    phase_image_cache(torch, card, ref["data"])
    phase_flops(torch, card, phase7, linear)
    phase_factor_repeat(torch, card, tmp, ref)
    print(f"phase 21 wall, (a) to (d), (g), (h) and the run-to-run check: {time.perf_counter() - t0:.1f} s; on "
          f"{card}", flush=True)
    return {"stats": stats, "linear": linear, "arc_chunks": arc["chunks"], "repeat_steps": 2 * REPEAT_STEPS,
            "K3": planes["K3"] + ewg["K3"], "K4 tables": planes["K4 tables"] + ewg["K4 tables"], "K8": ewg["K8"],
            "K9 tables": ewg["K9 tables"]}


# Phase 21 (f): flax's msgpack (flax/serialization.py) as the JAX package's
# scripts/convert_sdxl_weights.py writes it: nested maps of str keys, each
# array an ext of type 1 whose payload is the msgpack of (shape, dtype name,
# C-order bytes). This script imports neither flax (the card's machine has
# none) nor msgpack.
def _msgpack_uint(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32)):
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _msgpack_header(n: int, small: int, small_max: int, codes) -> bytes:
    if n < small_max:
        return bytes([small | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n}")


def _msgpack_str(s: str) -> bytes:
    raw = s.encode()
    return _msgpack_header(len(raw), 0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16))) + raw


def _msgpack_map(n: int) -> bytes:
    return _msgpack_header(n, 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))


def write_flax_msgpack(f, tree) -> int:
    """Write `tree` (nested dicts of f32 numpy arrays or a callable that
    gives one) to the open file `f`, one array at a time; -> bytes written."""
    written = f.write(_msgpack_map(len(tree)))
    for key, val in tree.items():
        written += f.write(_msgpack_str(str(key)))
        if isinstance(val, dict):
            written += write_flax_msgpack(f, val)
            continue
        arr = val()
        shape = _msgpack_header(arr.ndim, 0x90, 16, ((0xDC, ">H", 1 << 16),)) + b"".join(
            _msgpack_uint(d) for d in arr.shape)
        head = b"\x93" + shape + _msgpack_str(arr.dtype.name) + b"\xc6" + struct.pack(">I", arr.nbytes)
        written += f.write(b"\xc9" + struct.pack(">I", len(head) + arr.nbytes) + b"\x01" + head)
        written += f.write(memoryview(arr).cast("B"))
    return written


def jax_layout(torch, pipe) -> dict:
    """The pipeline's five components as the JAX params tree: the port's
    dotted names split into nested dicts, conv kernels from OIHW back to
    HWIO, each leaf a callable giving its f32 host copy."""
    from signerf_tpu_torch.convert import SDXL_COMPONENTS

    tree = {}
    for comp in SDXL_COMPONENTS:
        for name, t in getattr(pipe, comp).state_dict().items():
            node = tree.setdefault(comp, {})
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            hwio = leaf == "kernel" and t.dim() == 4
            node[leaf] = (lambda t=t, hwio=hwio: (t.permute(2, 3, 1, 0) if hwio else t).float().contiguous()
                          .cpu().numpy())
    return tree


def host_rss_gib() -> float:
    """This process's resident set, GiB (/proc/self/status)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    fail("/proc/self/status has no VmRSS")


class RssPeak:
    """The largest resident set seen while the block runs, sampled every
    20 ms by a thread."""

    def __enter__(self):
        import threading

        self.peak, self._stop = host_rss_gib(), threading.Event()

        def poll():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, host_rss_gib())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_gib())


def phase_last_sdxl(torch, card: str, sh: dict) -> dict:
    """Phase 21 (e) the VAE's posterior sample at 1024 px and (f) the full
    pipeline written in the JAX package's msgpack layout (f32), loaded by
    `SDXLInpaintPipeline.create`, every tensor checked, then one sampler
    step of the 1536 px sheet on it."""
    import warnings

    import numpy as np

    from signerf_tpu_torch.diffusion.sdxl_pipeline import SDXLInpaintPipeline
    from signerf_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    pipe = sh["diffuser"].pipeline
    vae = pipe.vae
    img = (torch.rand(1, 1024, 1024, 3, generator=torch.Generator().manual_seed(24)) * 2 - 1).to(dev)
    with torch.no_grad():
        mean = vae.encode(img)
        a = vae.encode(img, generator=torch.Generator(device=dev).manual_seed(5))
        b = vae.encode(img, generator=torch.Generator(device=dev).manual_seed(5))
        none = vae.encode(img, generator=None, noise=None)
        enc_ms = cuda_ms(lambda: vae.encode(img, generator=torch.Generator(device=dev).manual_seed(5)), 3)
    if not (torch.equal(a, b) and torch.equal(none, mean)) or torch.equal(a, mean) or not bool(
            torch.isfinite(a).all()):
        fail("VAE posterior: two draws of one generator differ, or noise=None is not the mean")
    moved = rel_err(a.float(), mean.float())
    print(f"phase 21(e) the SDXL VAE's posterior at 1024 px: latents {tuple(a.shape)} {a.dtype}; two encodes with "
          f"one seeded generator equal bit for bit, noise=None equal to the mean bit for bit, the sample "
          f"{moved:.3e} of the mean's norm from it; encode with a draw {enc_ms:.3f} ms; on {card}", flush=True)

    t_all = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_sdxl_msgpack"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        path = root / "sdxl_params.msgpack"
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            size = write_flax_msgpack(f, jax_layout(torch, pipe))
        write_s = time.perf_counter() - t0
        rss_before = host_rss_gib()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, RssPeak() as rss:
            warnings.simplefilter("always")
            loaded = SDXLInpaintPipeline.create(root)
        load_s = time.perf_counter() - t0
        rss_after = host_rss_gib()
        dev_peak = torch.cuda.max_memory_allocated() / 2**30 - base_alloc
        if any("RANDOM-INIT" in str(w.message) for w in caught):
            fail("create(weights_path) with sdxl_params.msgpack warned RANDOM-INIT")
        checked = 0
        for comp in ("unet", "controlnet", "vae", "clip_l", "clip_g"):
            want = getattr(pipe, comp).state_dict()
            got = getattr(loaded, comp).state_dict()
            if sorted(got) != sorted(want):
                fail(f"{comp}: the loaded names differ from the source's")
            for k, v in got.items():
                if v.dtype != torch.bfloat16 or not torch.equal(v, want[k]):
                    fail(f"{comp}.{k}: loaded {v.dtype} differs from the source's bf16")
                checked += 1
        fa.launches = 0
        t0 = time.perf_counter()
        out = loaded.img2img(sh["sheet"], "", mask=sh["mask"], control_image=sh["depth"], num_steps=2)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        steps = loaded.last_run["sampler_steps"]
        if steps != 1 or fa.launches != K7_PER_STEP or not np.isfinite(out).all() or out.shape != sh["sheet"].shape:
            fail(f"one sheet step on the loaded weights: {steps} steps, K7 {fa.launches} launches (expected "
                 f"{K7_PER_STEP}), output {out.shape}, finite {np.isfinite(out).all()}")
        launches = fa.launches
        del loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 21(f) JAX-format SDXL weights: the full pipeline written as flax msgpack of f32 arrays (the JAX "
          f"layout, conv kernels HWIO), {size / 1e9:.3f} GB in {write_s:.1f} s; SDXLInpaintPipeline.create read it "
          f"(memory-mapped, cast to bf16 leaf by leaf) in {load_s:.1f} s without the RANDOM-INIT warning, host "
          f"resident set {rss_before:.2f} GiB before, peak {rss.peak:.2f} GiB during and {rss_after:.2f} GiB after "
          f"the load, device peak {dev_peak:.2f} GiB above "
          f"the {base_alloc:.2f} GiB held before; {checked} tensors equal to the source's bf16; one 1536 px sheet "
          f"sampler step on them: K7 {launches} launches, output finite, {step_s:.3f} s; phase wall "
          f"{time.perf_counter() - t_all:.1f} s; on {card}", flush=True)
    return {"k7_launches": launches, "steps": 1}


# Phase 22, the repository's example scripts: the verification drive
# and the reference-scale edit pass through their own functions, at a cut scale.
FIT_DISPATCHES = 5  # 50 steps each, after the first
FIT_MIN_PSNR = 20.0  # dB on the analytic sphere after 300 steps of 4096 rays
# The pass at 2 views of 512 px (a 768 px sheet of 256 px cells), one chunk
# of the generator's batch, on the probe's NeRF of the ring at the same
# size: phases 23 to 25 need the time (on an H100 the whole smoke took
# 1063.3 s with 2 views of 1024 px; at 8 views the warm per-view marginal
# was 7.8 to 9.2 s a view; with one chunk the pass reports none).
NS_VIEWS, NS_SIZE, NS_PASS_SIZE = 2, 512, 512
NS_SHEET = SHEET_GRID * NS_PASS_SIZE // 2
# K7's shapes on the pass's sheet, with CFG sequential (B = 1) or batched
# (B = 2; 4 for two views at once): phase 15 times them.
K7_PASS_SHAPES = tuple(itertools.chain.from_iterable(k7_pass_shapes(NS_SHEET, NS_SHEET, b) for b in (1, 2, 4)))
NS_REFINE_STEPS = 100  # one train call of the pass (steps_per_call 100)
# The NeRF that the pass edits: on 8 views its depth stays behind the edit
# box after 1200 steps, so every mask is empty; on the pass's 100-view ring
# the masks fill after 500 to 2000 steps, but not in every run (one of
# three runs of one tree still had them empty at 2000: the runs part at f32
# rounding; PERF.md section 6), so the smoke pretrains until every
# reference mask is non-empty, checking at each of NS_PRETRAIN_STEPS (the
# trainer runs calls of 100; a check renders the 8 references twice), at
# most NS_PRETRAIN_STEPS[-1] steps. A step is the method's 16,384 rays in
# NS_PRETRAIN_MICRO micro-batches, not 4: the gradient is the same mean
# over the step's rays, and a step of 4 micro-batches waits on the host
# (idle 0.76 of it in the pass's profile: 170 to 200 ms a step on an
# H100, 109 ms in 2 micro-batches), which made the pretrain most of the
# smoke's wall. `phase_pretrain_calls` times its kernels at their N. The pass loads it from `load_dir`, as the reference
# edits an existing NeRF; the scene space is the same on both rings.
NS_PRETRAIN_VIEWS, NS_PRETRAIN_STEPS = 100, (1000, 1300, 1600, 2000, 2500)
NS_PRETRAIN_MICRO = 1


def phase_pretrain_calls(torch) -> dict:
    """The kernels of the pretrain's micro-batches (NS_PRETRAIN_MICRO a step
    of SIGNERF_RAYS), at shapes that phases 3 to 5 do not time: K1 and K2's
    tables half at the proposal fields' N, K3, K5 and the tables halves of
    K4 and K6 (with grad_g) at the base field's N, uniform coordinates,
    each against its plain twin (K1 and K3 by max abs error over max|ref|,
    the others norm-relative, with phases 3 to 5's bounds), then timed
    against it in turns, with its bound."""
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(22)
    rays = SIGNERF_RAYS // NS_PRETRAIN_MICRO
    keys = ("K1", "K2 tables", "K3", "K4 tables", "K5", "K6 tables")
    out = {"K1": {}, "K2 tables": {}, "max_abs_err": dict.fromkeys(keys, 0.0)}
    line = [f"phase 22 the pretrain's {rays}-ray micro-batches, kernel vs plain twin (error, ms):"]

    def entry(label, key, tol, got, want, n, kern, plain, b, floor=None):
        # got and want: the leaves; with `floor`, max abs error over max(max|ref|, floor), else norm-relative
        if floor is None:
            errs = [rel_err(a, w) for a, w in zip(got, want)]
        else:
            errs = [float((a - w).abs().max()) / max(float(w.abs().max()), floor) for a, w in zip(got, want)]
        if not all(bool(torch.isfinite(a).all()) for a in got) or max(errs) > tol:
            fail(f"{label} N={n}: errors {errs} against the twin (bound {tol}), or non-finite")
        out["max_abs_err"][key] = max([out["max_abs_err"][key]] + [float((a - w).abs().max())
                                                                   for a, w in zip(got, want)])
        k_ms, p_ms = twin_ms(torch, kern, plain)
        line.append(f"{label} N={n} {max(errs):.2e}, {k_ms:.4f} vs {p_ms:.4f} (bound {b[0]:.4f} {b[1]}, "
                    f"{b[0] / k_ms:.1%} of it);")
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0], "bound_by": b[1]}

    def run(fn, *args):
        got = fn(*args)
        torch.cuda.synchronize()
        return got

    for name, shape, per_ray in TRAIN_SCHEDULES[:2]:  # the proposal fields
        n = rays * per_ray
        args = make_case(torch, *shape, n, gen, dev)
        b = factor_bounds(args[0], args[1], args[2], n, shape[3], shape[4])
        out["K1"][name] = entry(f"K1 {name}", "K1", KERNEL_TOL, [run(ffc.density_mlp_cuda, *args)],
                                [ffc.density_mlp_plain(*args)], n, lambda: ffc.density_mlp_cuda(*args),
                                lambda: ffc.density_mlp_plain(*args), b["K1"], floor=1e-3)
        res, feat, tables, w0, b0, w1, _, x = args  # K2 takes no output bias, and K1's cotangent
        args = (res, feat, tables, w0, b0, w1, x, torch.randn(n, shape[4], generator=gen).to(dev))
        got, want = run(ffc.density_mlp_bwd_cuda, *args), ffc.density_mlp_bwd_plain(*args)
        out["K2 tables"][name] = entry(f"K2 tables {name}", "K2 tables", K2_TOL, [got[0], *got[1]],
                                       [want[0], *want[1]], n, lambda: ffc.density_mlp_bwd_cuda(*args),
                                       lambda: ffc.density_mlp_bwd_plain(*args), b["K2 tables"])
        del args, got, want, tables, x
    n = rays * TRAIN_SCHEDULES[2][2]
    args, g, ct = encode_case(torch, n, gen, dev)
    b = factor_bounds(args[0], args[1], args[2], n)
    out["K3"] = entry("K3", "K3", K3_TOL, [run(ffc.encode_cuda, *args)], [ffc.encode_plain(*args)], n,
                      lambda: ffc.encode_cuda(*args), lambda: ffc.encode_plain(*args), b["K3"], floor=1e-12)
    out["K4 tables"] = entry("K4 tables", "K4 tables", K456_TOL, [run(ffc.encode_bwd_cuda, *args, g)[0]],
                             [ffc.encode_bwd_plain(*args, g)[0]], n, lambda: ffc.encode_bwd_cuda(*args, g),
                             lambda: ffc.encode_bwd_plain(*args, g), b["K4 tables"])
    out["K5"] = entry("K5", "K5", K456_TOL, [run(ffc.grad_dot_cuda, *args, g)], [ffc.grad_dot_plain(*args, g)], n,
                      lambda: ffc.grad_dot_cuda(*args, g), lambda: ffc.grad_dot_plain(*args, g), b["K5"])
    out["K6 tables"] = entry("K6 tables and grad_g", "K6 tables", K456_TOL, run(ffc.grad_dot_bwd_cuda, *args, g, ct)[:2],
                             ffc.grad_dot_bwd_plain(*args, g, ct)[:2], n, lambda: ffc.grad_dot_bwd_cuda(*args, g, ct),
                             lambda: ffc.grad_dot_bwd_plain(*args, g, ct), b["K6 tables"])
    del args, g, ct
    torch.cuda.empty_cache()
    print(" ".join(line), flush=True)
    return out


NS_RESULT_KEYS = ("script", "commit", "date", "hardware", "cards", "n_views", "refine_steps", "pretrain_steps",
                  "loaded_checkpoint", "phases_s", "edit_pass_s", "edit_pass_min", "sheet_s", "sheet_warm_s",
                  "refine_rays_per_s", "warm_per_view_marginal_s", "view_s_first", "eval_psnr_db",
                  "edit_mask_coverage", "edit_landing_masked_delta", "edit_landing_unmasked_delta",
                  "edit_landing_ratio", "generation_batch_size", "reduced", "notes", "image_px", "sheet",
                  "warm_single_chip_edit_pass_min")


def finite_numbers(tree) -> bool:
    """Every int and float in a JSON-like tree is finite."""
    import math

    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def phase_scripts(torch, card: str) -> dict:
    """`examples/fit_synthetic_torch.py` (FIT_DISPATCHES dispatches), then
    `scripts/probe_edit_mask_torch.py`'s pretrain of the pass's NeRF
    (NS_PRETRAIN_STEPS on its NS_PRETRAIN_VIEWS-view ring; every reference
    mask non-empty) and `examples/north_star_pass_torch.py` at NS_VIEWS
    views of NS_PASS_SIZE px on that checkpoint (3x3 sheet, full-width SDXL at
    random init, EDIT_SDXL_STEPS steps; NS_REFINE_STEPS refinement steps), each through
    its own functions, with exact launches, the result's schema and finite
    numbers."""
    import gc

    from signerf_tpu_torch.diffusion.diffuser import Diffuser
    from signerf_tpu_torch.engine.checkpoints import save_checkpoint
    from signerf_tpu_torch.ops import flash_attention as fa
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    sys.path[:0] = [str(ROOT / "examples"), str(ROOT / "scripts")]
    import fit_synthetic_torch
    import north_star_pass_torch as ns
    import probe_edit_mask_torch as probe

    dev = torch.device("cuda")
    zero_counts(ffc)
    t0 = time.perf_counter()
    fit = fit_synthetic_torch.main(FIT_DISPATCHES, TRAIN_RAYS, "cuda")
    fit_s = time.perf_counter() - t0
    got = counts(ffc)
    want = NERFACTO_COUNTS(fit["steps"])
    want["K1"] += 3 * fit["eval_chunks"]
    losses = [loss for _, loss, _ in fit["trajectory"]]
    if got != want or not finite_numbers(fit) or not losses or not fit["eval_psnr_db"] >= FIT_MIN_PSNR:
        fail(f"fit_synthetic_torch: launched {got}, expected {want}; result {fit} (eval PSNR at least "
             f"{FIT_MIN_PSNR} dB)")
    print(f"phase 22 examples/fit_synthetic_torch.py {FIT_DISPATCHES} {TRAIN_RAYS}: {fit['params']} parameters, "
          f"{fit['steps']} steps, loss and PSNR at steps {fit['trajectory']}, first dispatch (kernel build, warm-up) "
          f"{fit['first_dispatch_s']:.2f} s, train {fit['train_rays_per_s']:.0f} rays/s (CUDA events), eval PSNR "
          f"{fit['eval_psnr_db']:.2f} dB; launches K1 {got['K1']}, K2 tables {got['K2 tables']}; wall {fit_s:.1f} s; "
          f"on {card}", flush=True)

    chunks = -(-NS_SIZE * NS_SIZE // CHUNK)  # a frame of the probe's ring
    pass_chunks = -(-NS_PASS_SIZE * NS_PASS_SIZE // CHUNK)  # and of the pass's

    def signerf_counts(micro: int, renders: int, chunks: int) -> dict:
        # a micro-batch's forward and backward, then the eval render's chunks (normals on)
        want = expect_counts(K1=2, K2_tables=2, K3=1, K4_tables=1, K5=1, K6_tables=1)(micro)
        for name, per_chunk in (("K1", 2), ("K3", 1), ("K5", 1)):
            want[name] += per_chunk * chunks * renders
        return want


    def pretrain_micro(cfg):
        cfg.pipeline.datamanager.micro_batches = NS_PRETRAIN_MICRO

    pre_calls = phase_pretrain_calls(torch)
    calls = []
    tmp = Path(tempfile.mkdtemp(prefix="north_star_"))
    try:
        zero_counts(ffc)
        t0 = time.perf_counter()
        trainer, rows = probe.probe(tmp / "pretrain", NS_PRETRAIN_VIEWS, NS_SIZE, NS_PRETRAIN_STEPS, dev,
                                    configure=pretrain_micro, until_filled=True)
        pre_steps = trainer.step
        settings = trainer.pipeline.datamanager.sampler_settings()
        if (settings.num_rays, settings.micro_batches) != (SIGNERF_RAYS, NS_PRETRAIN_MICRO):
            fail(f"the pass's pretrain ran {settings.num_rays} rays a step in {settings.micro_batches} micro-batches, "
                 f"expected {SIGNERF_RAYS} in {NS_PRETRAIN_MICRO}")
        pre_micro = pre_steps * NS_PRETRAIN_MICRO
        ckpt = save_checkpoint(tmp / "checkpoint", trainer.step, trainer.pipeline.model.state_dict(),
                               trainer.optimizer)
        pre_s = time.perf_counter() - t0
        del trainer
        probe_renders = 2 * ns.REFERENCE_VIEWS * len(rows)
        got, want = counts(ffc), signerf_counts(pre_micro, probe_renders, chunks)
        coverage = rows[-1]["coverage"]
        print(f"phase 22 scripts/probe_edit_mask_torch.py: {pre_steps} signerf steps of {SIGNERF_RAYS} rays in "
              f"{NS_PRETRAIN_MICRO} micro-batches on the pass's {NS_PRETRAIN_VIEWS}-view ring at {NS_SIZE} px (until "
              f"every reference mask filled; coverage "
              + ", ".join(f"{min(r['coverage']):.4f} at {r['steps']}" for r in rows) + f"), the last "
              f"{rows[-1]['train_s']:.1f} s; the {len(coverage)} "
              f"reference masks cover " + " ".join(f"{c:.4f}" for c in coverage) + "; of the rays crossing the box, "
              "depth in front " + " ".join(f"{c:.2f}" for c in rows[-1]["in_front"]) + ", behind "
              + " ".join(f"{c:.2f}" for c in rows[-1]["behind"]) + f"; launches K1 {got['K1']}, K3 {got['K3']}; "
              f"wall {pre_s:.1f} s; on {card}", flush=True)
        if got != want or not min(coverage) > 0:
            fail(f"the pass's pretrain: launched {got}, expected {want}; reference mask coverage {coverage}")
        zero_counts(ffc)
        fa.launches = 0
        t0 = time.perf_counter()
        def sdxl_steps(cfg):
            cfg.pipeline.dataset_generator.diffuser.num_inference_steps = EDIT_SDXL_STEPS

        result = ns.main([str(NS_VIEWS), str(NS_REFINE_STEPS), str(pre_steps), str(ckpt.parent),
                          "--device", "cuda", "--mesh", "none", "--size", str(NS_PASS_SIZE), "--out",
                          str(tmp / "pass")], configure=sdxl_steps,
                         make_diffuser=lambda c: recording_diffuser(Diffuser(c, device=dev), calls),
                         reduced=[f"SDXL num_inference_steps {EDIT_SDXL_STEPS} (reference {ns.SDXL_STEPS})"])
        ns_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = counts(ffc)
    micro = SIGNERF_MICRO * (NS_REFINE_STEPS + 1 + ns.PROFILE_STEPS)  # the profile's warm-up and window
    renders = NS_VIEWS + 2 * ns.REFERENCE_VIEWS + 1 + min(ns.EVAL_VIEWS, NS_VIEWS + ns.REFERENCE_VIEWS)
    want = signerf_counts(micro, renders, pass_chunks)
    k7_shapes = k7_launches(calls, NS_SHEET, NS_SHEET)
    if got != want or fa.launches != sum(k7_shapes.values()) or set(k7_shapes) - set(K7_PASS_SHAPES):
        fail(f"north_star_pass_torch: launched {got}, expected {want} ({micro} signerf micro-batches, {renders} renders of "
             f"{pass_chunks} chunks); K7 {fa.launches}, expected {sum(k7_shapes.values())} from the pipeline's schedule "
             f"{k7_shapes} (phase 15 times {K7_PASS_SHAPES})")
    if set(result) != set(NS_RESULT_KEYS) or not finite_numbers(result) or not result["edit_mask_coverage"] > 0:
        fail(f"north_star_pass_torch: result keys {tuple(result)}, expected {NS_RESULT_KEYS}; finite "
             f"{finite_numbers(result)}; edit mask coverage {result.get('edit_mask_coverage')}")
    ph = result["phases_s"]
    print(f"phase 22 examples/north_star_pass_torch.py {NS_VIEWS} {NS_REFINE_STEPS} {pre_steps} CHECKPOINT "
          f"--size {NS_PASS_SIZE}: walls setup {ph['setup']:.3f} s, generation "
          f"{ph['generation']:.3f} s (sheet {result['sheet_s']:.3f} s, first chunk {result['view_s_first']:.3f} s, "
          f"warm per-view marginal {result['warm_per_view_marginal_s']} s, batch {result['generation_batch_size']}), "
          f"sheet again {result['sheet_warm_s']:.3f} s, exchange {ph['exchange']:.3f} s, refine {ph['refine']:.3f} s "
          f"({result['refine_rays_per_s']} rays/s), eval {ph['eval']:.3f} s; edit pass {result['edit_pass_s']:.3f} "
          f"s; eval PSNR {result['eval_psnr_db']} dB, mask coverage {result['edit_mask_coverage']}, edit landing "
          f"ratio {result['edit_landing_ratio']}; {len(calls)} diffuse calls, serial views "
          f"{[r['serial_views'] for _, r in calls]}; launches K1 {got['K1']}, K2 tables {got['K2 tables']}, K3 "
          f"{got['K3']}, K4 tables {got['K4 tables']}, K5 {got['K5']}, K6 tables {got['K6 tables']}, K7 "
          f"{fa.launches}; wall {ns_s:.1f} s; on {card}", flush=True)
    for note in result["notes"]:
        print(f"phase 22 north star: {note}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22 wall {fit_s + pre_s + ns_s:.1f} s; on {card}", flush=True)
    return {"fit_steps": fit["steps"], "fit_chunks": fit["eval_chunks"], "micro": micro, "pre_micro": pre_micro,
            "pre_calls": pre_calls, "eval_chunks": pass_chunks * renders + chunks * probe_renders,
            "k7_shapes": k7_shapes, "k7_launches": fa.launches}


# Phase 23, data parallelism over the visible cards: one process a card on
# torch.distributed (signerf_tpu_torch/parallel/mesh.py).
DP_STEPS = 50  # (a): the `signerf` train CLI with --mesh data
DP_CHECK_STEPS = 4  # (b): DP steps from fed indices against one rank
DP_CHECK_RAYS = TRAIN_RAYS  # (b): `signerf_nerfacto` at 4096 global rays
# (b) DP against one rank on the same card: the same per-rank batches, but
# K2's tables half adds with atomics in no fixed order, and after Adam with
# eps = 1e-15 an element whose gradient is rounding noise can move by up to
# lr; so the loss within 1e-3 relative and each parameter leaf within 0.05
# norm-relative (STEP_TOL), over the DP_CHECK_STEPS steps.
DP_LOSS_RTOL = 1e-3
DP_PARAM_TOL = STEP_TOL
# (b) per-view generation: 4 views of 512 px, a 2x2 sheet of 256 px cells,
# SDXL at published widths (random init), 5 sampler steps, batches of 2.
DP_GEN = dict(views=4, rows=2, cols=2, steps=3, batch=2)  # 3 steps: 2 sampler steps at strength 0.9
DP_BOX = ((-0.35, -0.35, 0.25), (0.35, 0.35, 0.75))  # the edit box over the sphere's top, world space
DP_JOIN_S = 600.0  # a rank that hangs fails the phase


def dp_rank_counts(mesh, micro_batches: int, steps: int) -> dict:
    """A `signerf` rank's expected launches: each of its max(1, micro / W)
    micro-batches a step runs the proposal fields' K1 and K2 twice, the base
    field's K3 to K6 once."""
    micro = max(1, micro_batches // mesh.world_size)
    return expect_counts(K1=2, K2_tables=2, K3=1, K4_tables=1, K5=1, K6_tables=1)(micro * steps)


def max_rank_diff(torch, mesh, tensors) -> float:
    """max |t - rank 0's t| over `tensors`, on every rank."""
    worst = 0.0
    for t in tensors:
        ref = t.detach().clone()
        mesh.broadcast_([ref])
        worst = max(worst, float((t.detach() - ref).abs().max()))
    return max(mesh.gather_objects(worst))


def dp_train_rank(mesh, argv, out: str) -> int:
    """Phase 23(a) on one rank: the train CLI's own work (`train.parse`,
    `train._run`) with this rank's launches, CUDA events at each step's
    last micro-batch loss, wall, peak memory and the largest difference of
    its final parameters from rank 0's; rank 0 writes every rank's record."""
    import torch

    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.engine import trainer as ttrainer
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    events, trainers = [], []
    real_loss, real_setup = tts.default_loss_fn, ttrainer.SIGNeRFTrainer.setup

    def recording_loss(model, outputs, batch):
        total, ld = real_loss(model, outputs, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return total, ld

    def setup(self, *a, **k):
        trainers.append(self)
        return real_setup(self, *a, **k)

    _, _, config, train_only = cli.parse(argv)
    tts.default_loss_fn, ttrainer.SIGNeRFTrainer.setup = recording_loss, setup
    torch.cuda.reset_peak_memory_stats(mesh.device)
    zero_counts(ffc)
    try:
        t0 = time.perf_counter()
        rc = cli._run(mesh, config, mesh.device, train_only)
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
    finally:
        tts.default_loss_fn, ttrainer.SIGNeRFTrainer.setup = real_loss, real_setup
    (trainer,) = trainers
    micro = max(1, trainer.pipeline.datamanager.sampler_settings().micro_batches // mesh.world_size)
    ends = events[micro - 1 :: micro]
    step_ms = sorted(ends[i - 1].elapsed_time(ends[i]) for i in range(11, len(ends)))
    record = {"rank": mesh.rank, "device": str(mesh.device), "launches": counts(ffc), "steps": trainer.step,
              "micro": micro, "median_ms": step_ms[len(step_ms) // 2], "range_ms": (step_ms[0], step_ms[-1]),
              "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30,
              "expected": dp_rank_counts(mesh, trainer.pipeline.datamanager.sampler_settings().micro_batches,
                                         trainer.step)}
    record["param_diff"] = max_rank_diff(torch, mesh, trainer.pipeline.model.state_dict().values())
    records = mesh.gather_objects(record)
    if mesh.is_main:
        Path(out).write_text(json.dumps({"backend": mesh.backend, "world": mesh.world_size, "ranks": records}))
    return rc


def dp_render_fn(torch):
    """The analytic scene (phase 6's sphere on a grey backdrop) as the
    generator's render function: rgb [H, W, 3] and along-ray depth [H, W, 1]
    of camera `index`, on the cameras' device."""

    def render(cameras, index):
        rb = cameras.generate_rays(camera_index=index)
        o, d = rb.origins, rb.directions
        b = (o * d).sum(-1)
        disc = b * b - ((o * o).sum(-1) - SPHERE_RADIUS**2)
        hit = disc > 0
        t = torch.where(hit, -b - torch.sqrt(disc.clamp_min(0.0)), torch.full_like(b, 10.0))
        p = o + d * t[..., None]
        rgb = torch.where(hit[..., None], p.abs() / SPHERE_RADIUS, torch.full_like(p, REFERENCE_BACKDROP))
        return {"rgb": rgb.clamp(0.0, 1.0), "depth": t[..., None]}

    return render


def same_dataset(a: Path, b: Path) -> dict:
    """tests/test_torch_edit_flow.py's `assert_same_dataset` rule: the same
    PNGs, each within one 8-bit level with at most 5% of its values one level
    apart; transforms.json equal but for poses within 1e-6. Returns the
    worst level and share (fails otherwise)."""
    import numpy as np

    pa = sorted(p.relative_to(a).as_posix() for p in a.rglob("*.png"))
    pb = sorted(p.relative_to(b).as_posix() for p in b.rglob("*.png"))
    if pa != pb:
        fail(f"phase 23(b) datasets hold other PNGs: {sorted(set(pa) ^ set(pb))[:5]}")
    worst, share = 0, 0.0
    for name in pa:
        diff = np.abs(read_png(a / name).astype(np.int32) - read_png(b / name).astype(np.int32))
        worst, share = max(worst, int(diff.max())), max(share, float((diff > 0).mean()))
    ta, tb = (json.loads((x / "transforms.json").read_text()) for x in (a, b))
    frames_a, frames_b = ta.pop("frames"), tb.pop("frames")
    poses_ok = len(frames_a) == len(frames_b) and all(
        {k: v for k, v in fa.items() if not k.endswith("transform_matrix")}
        == {k: v for k, v in fb.items() if not k.endswith("transform_matrix")}
        and all(np.allclose(fa[k], fb[k], rtol=0, atol=1e-6) for k in fa if k.endswith("transform_matrix"))
        for fa, fb in zip(frames_a, frames_b))
    if worst > 1 or share > 0.05 or ta != tb or not poses_ok:
        fail(f"phase 23(b): the dataset of the ranks differs from one rank's: worst level {worst}, share {share:.4f}, "
             f"transforms equal {ta == tb}, frames equal {poses_ok}")
    return {"pngs": len(pa), "worst_level": worst, "share": share}


def generate_views(torch, run_mesh, diffuser, dev, path: Path):
    """The per-view generation of phases 23(b) and 24(c): DP_GEN's views of
    the analytic scene (`dp_render_fn`) at SCENE's size through `diffuser`,
    on the ranks of `run_mesh` (None: one process), into `path`. Returns
    the dataset's directory and {wall_s, k7, chunks_s}."""
    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.generator.datasetgenerator import DatasetGenerator, DatasetGeneratorConfig
    from signerf_tpu_torch.ops import flash_attention as fa

    h, w = SCENE["height"], SCENE["width"]
    f = 0.8 * w
    refs = circle_poses(DP_GEN["rows"] * DP_GEN["cols"] - 1, radius=2.0, theta=70.0, phi=(0.0, 240.0)).numpy()
    views = circle_poses(DP_GEN["views"], radius=2.0, theta=60.0, phi=(20.0, 290.0)).numpy()
    cfg = DatasetGeneratorConfig(path=path, dataset_name="dp", fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h,
                                 rows=DP_GEN["rows"], cols=DP_GEN["cols"], aabb_min=DP_BOX[0], aabb_max=DP_BOX[1],
                                 generation_batch_size=DP_GEN["batch"])
    gen = DatasetGenerator(cfg, np.eye(4)[:3], 1.0, lambda p: p, dp_render_fn(torch), diffuser=diffuser, device=dev,
                           mesh=run_mesh)
    fa.launches = 0
    t0 = time.perf_counter()
    out = gen.generate_dataset(reference_camera_to_worlds=refs[:, :3], synthetic_camera_to_worlds=views[:, :3])
    torch.cuda.synchronize(dev)
    lo = gen._layout()
    return out, {"wall_s": time.perf_counter() - t0, "k7": fa.launches, "chunks_s": gen.last_timings["view_s"],
                 "sheet_hw": (lo.height, lo.width)}


def dp_checks_rank(mesh, data: str, out: str, one_root: str) -> int:
    """Phase 23(b) on one rank: DP_CHECK_STEPS DP steps from fed indices, a
    512 px frame and the per-view generation on the ranks; on rank 0 the
    same work on one rank (its dataset into `one_root`, which phase 24(c)
    reads), compared. Rank 0 writes the record."""
    import numpy as np
    import torch

    from signerf_tpu_torch.data.datamanager import SIGNeRFDataManager, SIGNeRFDataManagerConfig
    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig
    from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev, ranks = mesh.device, mesh.world_size
    dm = SIGNeRFDataManager(SIGNeRFDataManagerConfig(dataparser=SIGNeRFDataParserConfig(data=Path(data))), dev)
    h, w = dm.cameras.height, dm.cameras.width
    rng = np.random.default_rng(23)
    table = np.stack([rng.integers(0, dm.num_images, DP_CHECK_RAYS), rng.integers(0, h, DP_CHECK_RAYS),
                      rng.integers(0, w, DP_CHECK_RAYS)], -1).reshape(ranks, -1, 3)
    settings = tts.SamplerSettings(num_rays=DP_CHECK_RAYS, micro_batches=ranks)

    def train(run_mesh, idx):
        model = NerfactoModel(NerfactoModelConfig(), dm.num_images)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(dev)
        if run_mesh is not None:
            run_mesh.broadcast_module_(model)
        real = tts._sample_indices
        tts._sample_indices = lambda *a, **k: idx
        try:
            fn = tts.make_train_step(model, make_optimizer(OptimizersConfig(), model), dm.cameras, settings,
                                     mesh=run_mesh)
            losses = [float(fn(step, dm.images, None, None)["total_loss"]) for step in range(DP_CHECK_STEPS)]
        finally:
            tts._sample_indices = real
        return model, losses

    # DP steps against one rank on the concatenated indices
    zero_counts(ffc)
    model, losses = train(mesh, torch.as_tensor(table[mesh.rank], device=dev))
    record = {"rank_launches": counts(ffc), "param_diff": max_rank_diff(torch, mesh, model.state_dict().values())}
    if mesh.is_main:
        one, one_losses = train(None, torch.as_tensor(table.reshape(-1, 3), device=dev))
        ref = one.state_dict()
        record.update(losses=losses, one_losses=one_losses, leaf_rel=max(rel_err(v, ref[k]) for k, v in
                                                                         model.state_dict().items()))

    # a 512 px frame: the ranks' chunks against one rank's
    model.eval()
    aabb = torch.as_tensor(dm.outputs.scene_box_aabb, device=dev)
    rays = dm.cameras.generate_rays(camera_index=0, aabb=aabb).reshape((h * w,))
    frame = tts.make_eval_render(model, chunk_size=CHUNK, mesh=mesh)(rays)
    if mesh.is_main:
        single = tts.make_eval_render(model, chunk_size=CHUNK)(rays)
        record["frame_equal"] = {k: bool(torch.equal(frame[k], single[k])) for k in single}

    # the per-view generation: the ranks' dealt chunks against one rank
    diffuser = Diffuser(DiffuserConfig(num_inference_steps=DP_GEN["steps"]), device=dev)

    def generate(run_mesh, path):
        return generate_views(torch, run_mesh, diffuser, dev, path)

    dp_path, dp_gen = generate(mesh, Path(out).parent / "ranks")
    record.update(gen=dp_gen, sdxl_init_s=diffuser.pipeline.init_seconds)
    if mesh.is_main:
        one_path, one_gen = generate(None, Path(one_root))
        record.update(one_gen=one_gen, same=same_dataset(Path(one_path), Path(dp_path)))
    records = mesh.gather_objects(record)
    if mesh.is_main:
        Path(out).write_text(json.dumps({"backend": mesh.backend, "world": ranks, "devices": mesh.gather_objects(
            str(dev)), "ranks": records}))
    else:
        mesh.gather_objects(str(dev))
    return 0


def phase_data_parallel(torch, card: str, one_root: Path) -> dict:
    """Phase 23: (a) the `signerf` train CLI with --mesh data on every
    visible card (NCCL; on one card a process group of 1), DP_STEPS steps of
    16,384 global rays on 14c's scene: each rank's launches, step median
    and peak memory, equal parameters on every rank; (b) at max(W, 2) ranks
    (NCCL a card each on W >= 2 cards, else gloo with both ranks on cuda:0):
    DP_CHECK_STEPS DP steps against one rank on the concatenated indices,
    a 512 px frame against one rank's bit for bit, and the per-view
    generation through SDXL against one rank's dataset."""
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    cards = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        data = write_scene(tmp / "scene", backdrop=REFERENCE_BACKDROP)
        out = tmp / "a.json"
        argv = train_argv("signerf", data, tmp / "a", DP_STEPS, mesh="data")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            rc = mesh_lib.run("data", torch.device("cuda"), tmp, dp_train_rank, (argv, str(out)))
        except Exception as exc:  # a rank failed: its error is above
            fail(f"phase 23(a): the data-parallel train CLI failed: {exc!r}")
        wall_a = time.perf_counter() - t0
        a = json.loads(out.read_text())
        if rc != 0 or a["world"] != cards or a["backend"] != "nccl":
            fail(f"phase 23(a): rc {rc}, {a['world']} ranks over {a['backend']} on {cards} cards")
        for r in a["ranks"]:
            if r["launches"] != r["expected"] or r["param_diff"] != 0.0 or r["steps"] != DP_STEPS:
                fail(f"phase 23(a) rank {r['rank']}: launches {r['launches']}, expected {r['expected']}; "
                     f"{r['steps']} steps; max |param - rank 0's| {r['param_diff']}")
            launched = ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v)
            print(f"phase 23(a) train CLI signerf --mesh data, rank {r['rank']} of {a['world']} ({a['backend']}) on "
                  f"{r['device']}: {r['steps']} steps of {SIGNERF_RAYS} global rays, {SIGNERF_RAYS // a['world']} "
                  f"on this card in {r['micro']} micro-batches; launches {launched}, all others 0; warm step median "
                  f"{r['median_ms']:.3f} ms (range {r['range_ms'][0]:.3f} to {r['range_ms'][1]:.3f}) = "
                  f"{SIGNERF_RAYS / r['median_ms'] * 1e3:.0f} global rays/s; rank wall {r['wall_s']:.3f} s; peak "
                  f"memory {r['peak_gib']:.3f} GiB; max |param - rank 0's| {r['param_diff']}; on {card}", flush=True)
        torch.cuda.empty_cache()

        ranks = max(cards, 2)
        backend = "nccl" if cards >= 2 else "gloo"
        out_b = tmp / "b" / "b.json"
        out_b.parent.mkdir()
        t0 = time.perf_counter()
        try:
            mesh_lib.spawn(dp_checks_rank, (str(data), str(out_b), str(one_root)), ranks, tmp, device_type="cuda",
                           backend=backend, cards=min(cards, ranks), join_timeout_s=DP_JOIN_S)
        except Exception as exc:
            fail(f"phase 23(b): a rank failed: {exc!r}")
        wall_b = time.perf_counter() - t0
        b = json.loads(out_b.read_text())
        main_rank = b["ranks"][0]
        losses, one_losses = main_rank["losses"], main_rank["one_losses"]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses, one_losses))
        nerf_counts = expect_counts(K1=3, K2_tables=3)(DP_CHECK_STEPS)
        bad = [r["rank_launches"] for r in b["ranks"] if r["rank_launches"] != nerf_counts]
        # K7 runs on rank 0 (the sheet) and on every rank dealt a chunk of views
        chunks = -(-DP_GEN["views"] // DP_GEN["batch"])
        k7_ok = [(r["gen"]["k7"] > 0) == (rank == 0 or rank < chunks) for rank, r in enumerate(b["ranks"])]
        if (b["backend"] != backend or b["world"] != ranks or bad or loss_rel > DP_LOSS_RTOL
                or main_rank["leaf_rel"] > DP_PARAM_TOL or any(r["param_diff"] != 0.0 for r in b["ranks"])
                or not all(main_rank["frame_equal"].values()) or not all(k7_ok)):
            fail(f"phase 23(b): {b['world']} ranks over {b['backend']}; launches {bad or 'as expected'} (expected "
                 f"{nerf_counts}); losses {losses} against one rank's {one_losses} (max rel {loss_rel:.3g}, at most "
                 f"{DP_LOSS_RTOL}); worst leaf {main_rank['leaf_rel']:.3g} (at most {DP_PARAM_TOL}); rank param "
                 f"diffs {[r['param_diff'] for r in b['ranks']]}; frame equal {main_rank['frame_equal']}; K7 "
                 f"{[r['gen']['k7'] for r in b['ranks']]} (nonzero on rank 0 and the ranks of the {chunks} chunks)")
        same = main_rank["same"]
        print(f"phase 23(b) equality checks at {ranks} ranks over {b['backend']} on {b['devices']}: "
              f"{DP_CHECK_STEPS} DP signerf_nerfacto steps of {DP_CHECK_RAYS} global rays from fed indices, each "
              f"rank K1 {b['ranks'][0]['rank_launches']['K1']} and K2 tables "
              f"{b['ranks'][0]['rank_launches']['K2 tables']}: losses {[round(x, 6) for x in losses]} against one "
              f"rank on the concatenated indices {[round(x, 6) for x in one_losses]} (max rel {loss_rel:.3g}), "
              f"worst parameter leaf {main_rank['leaf_rel']:.3g} norm-relative, ranks' parameters equal; a "
              f"{SCENE['width']} px frame equal to one rank's bit for bit; per-view generation of "
              f"{DP_GEN['views']} views of {SCENE['width']} px ({DP_GEN['rows']}x{DP_GEN['cols']} sheet, SDXL at "
              f"published widths, random init, {DP_GEN['steps']} steps, batch {DP_GEN['batch']}): ranks' walls "
              + ", ".join(f"{r['gen']['wall_s']:.3f}" for r in b["ranks"]) + f" s (K7 "
              + ", ".join(str(r["gen"]["k7"]) for r in b["ranks"]) + f"), one rank's {main_rank['one_gen']['wall_s']:.3f} "
              f"s (K7 {main_rank['one_gen']['k7']}); {same['pngs']} PNGs, worst {same['worst_level']} level(s) apart "
              f"on {same['share']:.4f} of a file's values; SDXL created in "
              + ", ".join(f"{r['sdxl_init_s']:.2f}" for r in b["ranks"]) + " s on the ranks; wall of the spawned "
              f"ranks {wall_b:.1f} s; on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 23 wall {wall_a + wall_b:.1f} s; on {card}", flush=True)
    rank0 = a["ranks"][0]
    return {"micro": rank0["micro"] * rank0["steps"], "world": a["world"]}


# Phase 24, tensor parallelism: the SDXL UNet and ControlNet sharded over
# tensor groups of TP consecutive ranks (signerf_tpu_torch/parallel/mesh.py's
# tensor axis, diffusion/unet.py's sharded blocks), K7 on each rank's heads.
TP = 2
TP_JOIN_S = 600.0
TP_SHEET = dict(grid=2, steps=3)  # (b): a 2x2 sheet of 512 px cells, num_inference_steps 3
# (a) One CFG branch at the sheet shape against phase 18's one-rank branch:
# each row-parallel product sums two bf16 partials in f32 and rounds once
# where one rank rounds the whole product once, a flipped bf16 rounding per
# layer that 104 blocks carry on (1.34e-2 norm-relative at the tiny config
# on the CPU, tests/test_torch_tensor_parallel.py). Bound 0.1, as phase
# 18's K7 against the twin.
TP_BRANCH_TOL = 0.1
# (b) The 2x2 sheet's inpaint against one rank's, mean |err| over the image
# in [0, 1]: the CPU tests' img2img bound (tests/test_diffusion.py:299).
TP_SHEET_MEAN = 2e-2
# (c) The per-view generation against phase 23's one-rank dataset:
# assert_same_dataset's rule for the PNGs no inpaint touches (renders,
# masks, conditions); the edited ones 4 levels apart on average over a file
# at most (tests/test_torch_tensor_parallel.py's mean bound for the tiny
# SDXL) and at most 5% of a file's values more than 8 levels apart. With
# random weights the ancestral sampler turns a flipped bf16 rounding into
# another value for a few pixels: on the H100 (two gloo ranks on one card)
# the mean was 0.101 levels and single values 84 levels apart, so no bound
# is put on a single value.
TP_GEN_MEAN_LEVELS, TP_GEN_FAR, TP_GEN_FAR_SHARE = 4.0, 8, 0.05
TP_EDITED = ("images/", "images_2/", "references/edited_reference_sheet.png")


def tp_shapes(shapes: dict) -> dict:
    """{(B, S, H): calls} with each H split over the TP ranks."""
    return {(b, s, h // TP): n for (b, s, h), n in shapes.items()}


# The shapes phase 24 runs K7 at (phase 15 times every one of them): one
# branch of the 1536 px sheet (a), the 1024 px sheet with batched CFG (b),
# the per-view generation's 512 px sheet alone and in chunks of 2 views (c).
K7_TP_SHAPES = tuple(itertools.chain.from_iterable(
    tp_shapes(k7_pass_shapes(px, px, b)) for px, b in ((1536, 1), (1024, 2), (512, 2), (512, 4))))
# Phase 25(b)'s: the edit pass's shapes at a rank's heads (the viewer's
# sheet and chunks of views on a (1, 2) mesh).
K7_TP_EDIT_SHAPES = tuple(tp_shapes(dict.fromkeys(K7_EDIT_SHAPES, 0)))


def tp_inputs(ref: dict, sh: dict) -> dict:
    """(a)'s sheet and depth (phase 18's inputs) and (b)'s 2x2 sheet: the
    top-left 2x2 cells of phase 14c's reference sheet, mask and condition."""
    px = TP_SHEET["grid"] * SHEET_CELL
    return {"sheet": sh["sheet"], "depth": sh["depth"],
            **{f"b_{k}": ref[f"{k}_sheet"][:px, :px].cpu().numpy() for k in ("image", "mask", "cond")}}


def phase_tp_reference(torch, card: str, sh: dict, inputs: dict) -> dict:
    """Phase 24(b)'s one-rank reference, on phase 16's pipeline: the 2x2
    sheet through `Diffuser.diffuse` at TP_SHEET's steps."""
    import dataclasses

    from signerf_tpu_torch.diffusion.diffuser import Diffuser

    base = sh["diffuser"]
    diffuser = Diffuser(dataclasses.replace(base.config, num_inference_steps=TP_SHEET["steps"]),
                        pipeline=base.pipeline)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = diffuser.diffuse(inputs["b_image"], inputs["b_image"], inputs["b_mask"], inputs["b_cond"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    med, _, _ = step_stats(base.pipeline)
    return {"image": out, "wall_s": wall, "step_ms": med, "steps": base.pipeline.last_run["sampler_steps"]}


def tp_rank(mesh, inputs_path: str, out: str) -> int:
    """Phase 24 on one rank: the SDXL stack at random init sharded over this
    rank's tensor group; (a) one CFG branch at the 1536 px sheet shape, (b)
    `Diffuser.diffuse` on the 2x2 sheet, (c) the per-view generation on the
    mesh. Each call's K7 launches by shape, walls, step medians and peak
    memory; the outputs of (a) and (b) to files. Rank 0 writes every
    rank's record."""
    import dataclasses

    import numpy as np
    import torch

    from signerf_tpu_torch.diffusion import unet as unet_mod
    from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
    from signerf_tpu_torch.ops import flash_attention as fa

    dev = mesh.device
    data = dict(np.load(inputs_path))
    shapes: dict = {}
    real = unet_mod.flash_attention

    def recording(q, k, v, scale):
        key = tuple(q.shape[:3])
        shapes[key] = shapes.get(key, 0) + 1
        return real(q, k, v, scale)

    def counted(fn):
        """fn()'s result, and K7's launches in it: by shape, in all."""
        shapes.clear()
        fa.launches = 0
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, {"shapes": dict(shapes), "launches": fa.launches, "wall_s": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}

    unet_mod.flash_attention = recording
    try:
        diffuser = Diffuser(DiffuserConfig(), device=dev, mesh=mesh)
        pipe, init = counted(lambda: diffuser.pipeline)
        blocks = pipe.unet.core
        rec = {"rank": mesh.rank, "device": str(dev), "init": init, "init_s": pipe.init_seconds,
               "heads": (blocks.down_1_attn_0.blocks_0.attn1.num_heads, blocks.down_2_attn_0.blocks_0.attn1.num_heads),
               "bytes": {kind: sum(t.numel() * t.element_size() for t in pipe.tensors(sharded=kind))
                         for kind in (True, False)}}
        eps = cfg_branch(torch, pipe, data)
        with torch.no_grad():
            e, rec["a"] = counted(lambda: eps(1))
        torch.save(e.float().cpu(), Path(out) / f"a_rank{mesh.rank}.pt")

        sheet = Diffuser(dataclasses.replace(diffuser.config, num_inference_steps=TP_SHEET["steps"]), pipeline=pipe)
        calls = []
        recording_diffuser(sheet, calls)
        img, rec["b"] = counted(lambda: sheet.diffuse(data["b_image"], data["b_image"], data["b_mask"],
                                                      data["b_cond"]))
        rec["b"]["expected"] = tp_shapes(k7_launches(calls, *data["b_image"].shape[:2]))
        rec["b"]["step_ms"] = step_stats(pipe)
        np.save(Path(out) / f"b_rank{mesh.rank}.npy", img)

        calls = []
        views = recording_diffuser(Diffuser(DiffuserConfig(num_inference_steps=DP_GEN["steps"]), device=dev,
                                            pipeline=pipe, mesh=mesh), calls)
        (path, gen), rec["c"] = counted(lambda: generate_views(torch, mesh, views, dev, Path(out) / "c"))
        rec["c"].update(gen, path=str(path), expected=tp_shapes(k7_launches(calls, *gen["sheet_hw"])))
    finally:
        unet_mod.flash_attention = real
    records = mesh.gather_objects(rec)
    if mesh.is_main:
        torch.save({"backend": mesh.backend, "world": mesh.world_size, "tensor": mesh.tensor, "ranks": records},
                   Path(out) / "records.pt")
    return 0


def tp_same_dataset(one: Path, tp: Path) -> dict:
    """Phase 24(c)'s rule (TP_GEN_*): the same PNGs and transforms.json;
    untouched PNGs within assert_same_dataset's one level on 5% of the
    values, edited ones within TP_GEN_MEAN_LEVELS on average and with at
    most TP_GEN_FAR_SHARE of their values more than TP_GEN_FAR levels
    apart. Returns the worst of each (fails otherwise)."""
    import numpy as np

    pa = sorted(p.relative_to(one).as_posix() for p in one.rglob("*.png"))
    pb = sorted(p.relative_to(tp).as_posix() for p in tp.rglob("*.png"))
    if pa != pb:
        fail(f"phase 24(c): the datasets hold other PNGs: {sorted(set(pa) ^ set(pb))[:5]}")
    worst = {"untouched_level": 0, "untouched_share": 0.0, "edited_level": 0, "edited_mean": 0.0, "edited_far": 0.0}
    for name in pa:
        diff = np.abs(read_png(one / name).astype(np.int32) - read_png(tp / name).astype(np.int32))
        if name.startswith(TP_EDITED):
            worst["edited_level"] = max(worst["edited_level"], int(diff.max()))
            worst["edited_mean"] = max(worst["edited_mean"], float(diff.mean()))
            worst["edited_far"] = max(worst["edited_far"], float((diff > TP_GEN_FAR).mean()))
        else:
            worst["untouched_level"] = max(worst["untouched_level"], int(diff.max()))
            worst["untouched_share"] = max(worst["untouched_share"], float((diff > 0).mean()))
    same_meta = (json.loads((one / "transforms.json").read_text()) == json.loads((tp / "transforms.json").read_text()))
    if (worst["untouched_level"] > 1 or worst["untouched_share"] > 0.05 or worst["edited_mean"] > TP_GEN_MEAN_LEVELS
            or worst["edited_far"] > TP_GEN_FAR_SHARE or not same_meta):
        fail(f"phase 24(c): the TP dataset differs from one rank's beyond its bound: {worst}, transforms.json equal "
             f"{same_meta}")
    return dict(worst, pngs=len(pa))


def phase_tensor_parallel(torch, card: str, inputs: dict, eps_one, reference: dict, one_root: Path) -> dict:
    """Phase 24: max(W, 2) ranks with tensor=TP (NCCL a card a rank on
    W >= 2 cards, else two gloo ranks on cuda:0), the SDXL sharded over each
    tensor group: (a) one CFG branch against phase 18's, (b) the 2x2 sheet
    (`inputs`: `tp_inputs`) against `reference` (one rank, phase 16's
    pipeline), (c) the per-view
    generation on the mesh against phase 23's one-rank dataset in
    `one_root`. Outputs bit-equal within each tensor group; K7's exact
    launches by shape on every rank. Returns rank 0's K7 launches."""
    import numpy as np

    from signerf_tpu_torch.parallel import mesh as mesh_lib

    cards = torch.cuda.device_count()
    ranks = max(cards, TP)
    backend = "nccl" if cards >= 2 else "gloo"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        np.savez(tmp / "inputs.npz", **inputs)
        try:
            mesh_lib.spawn(tp_rank, (str(tmp / "inputs.npz"), str(tmp)), ranks, tmp, device_type="cuda",
                           backend=backend, cards=min(cards, ranks), join_timeout_s=TP_JOIN_S, tensor=TP)
        except Exception as exc:  # a rank failed: its error is above
            fail(f"phase 24: a rank failed: {exc!r}")
        res = torch.load(tmp / "records.pt", weights_only=False)
        recs = res["ranks"]
        if (res["backend"], res["world"], res["tensor"]) != (backend, ranks, TP):
            fail(f"phase 24: {res['world']} ranks over {res['backend']} with tensor {res['tensor']}")
        want_a = tp_shapes(k7_pass_shapes(SHEET_GRID * SHEET_CELL, SHEET_GRID * SHEET_CELL, 1))
        a = [torch.load(tmp / f"a_rank{r}.pt") for r in range(ranks)]
        b = [np.load(tmp / f"b_rank{r}.npy") for r in range(ranks)]
        a_err = [rel_err(e, eps_one) for e in a]
        b_err = [float(np.abs(x.astype(np.float64) - reference["image"]).mean()) for x in b]
        for r, rec in enumerate(recs):
            first = r - r % TP  # the first rank of r's tensor group
            bad = []
            if rec["heads"] != (10 // TP, 20 // TP):
                bad.append(f"local heads {rec['heads']}")
            if rec["a"]["shapes"] != want_a or rec["a"]["launches"] != sum(want_a.values()):
                bad.append(f"(a) K7 {rec['a']['shapes']} ({rec['a']['launches']} launches), expected {want_a}")
            for part in ("b", "c"):
                if rec[part]["shapes"] != rec[part]["expected"] or rec[part]["launches"] != sum(
                        rec[part]["shapes"].values()):
                    bad.append(f"({part}) K7 {rec[part]['shapes']} ({rec[part]['launches']} launches), expected "
                               f"{rec[part]['expected']}")
            if not torch.equal(a[r], a[first]) or not np.array_equal(b[r], b[first]):
                bad.append(f"outputs differ from rank {first}'s (its tensor group)")
            if not bool(torch.isfinite(a[r]).all()) or a_err[r] > TP_BRANCH_TOL:
                bad.append(f"(a) eps {a_err[r]:.3g} norm-relative from phase 18's (bound {TP_BRANCH_TOL})")
            if b[r].shape != reference["image"].shape or not np.isfinite(b[r]).all() or b_err[r] > TP_SHEET_MEAN:
                bad.append(f"(b) {b[r].shape}, mean |err| {b_err[r]:.4g} against one rank (bound {TP_SHEET_MEAN})")
            if bad:
                fail(f"phase 24 rank {r}: " + "; ".join(bad))
        for rec in recs:
            byt = rec["bytes"]
            print(f"phase 24 rank {rec['rank']} of {ranks} ({backend}, tensor {TP}, view group {rec['rank'] // TP}) "
                  f"on {rec['device']}: SDXL created sharded in {rec['init_s']:.2f} s, holding {byt[True] / 1e9:.3f} "
                  f"GB of shards and {byt[False] / 1e9:.3f} GB whole, local heads {rec['heads']}, peak "
                  f"{rec['init']['peak_gib']:.2f} GiB; (a) one CFG branch at the {SHEET_GRID * SHEET_CELL} px sheet: "
                  f"K7 {rec['a']['launches']} ({rec['a']['shapes']}), wall {rec['a']['wall_s']:.3f} s, peak "
                  f"{rec['a']['peak_gib']:.2f} GiB, eps {a_err[rec['rank']]:.3e} norm-relative from phase 18's; (b) "
                  f"the 2x2 sheet: K7 {rec['b']['launches']}, wall {rec['b']['wall_s']:.3f} s, sampler step median "
                  f"{rec['b']['step_ms'][0]:.2f} ms, peak {rec['b']['peak_gib']:.2f} GiB, mean |err| "
                  f"{b_err[rec['rank']]:.4g} against one rank; (c) the generation: K7 {rec['c']['launches']}, wall "
                  f"{rec['c']['wall_s']:.3f} s, peak {rec['c']['peak_gib']:.2f} GiB; on {card}", flush=True)
        same = tp_same_dataset(Path(one_root) / "dp", Path(recs[0]["c"]["path"]))
        print(f"phase 24 tensor parallelism at {ranks} ranks over {backend}, tensor {TP} (data {ranks // TP}): "
              f"outputs bit-equal within each tensor group; (a) eps within {max(a_err):.3e} of phase 18's one-rank "
              f"branch (bound {TP_BRANCH_TOL}); (b) the {TP_SHEET['grid']}x{TP_SHEET['grid']} sheet of "
              f"{SHEET_CELL} px cells at {TP_SHEET['steps']} steps within {max(b_err):.4g} mean |err| of one rank's "
              f"(bound {TP_SHEET_MEAN}; one rank's wall {reference['wall_s']:.3f} s, step median "
              f"{reference['step_ms']:.2f} ms); (c) {DP_GEN['views']} views of {SCENE['width']} px against phase "
              f"23's one-rank dataset: {same['pngs']} PNGs, untouched ones at most {same['untouched_level']} "
              f"level(s) apart on {same['untouched_share']:.4f} of a file, edited ones {same['edited_mean']:.3f} "
              f"levels apart on average (bound {TP_GEN_MEAN_LEVELS}), {same['edited_far']:.4f} of a file's values "
              f"more than {TP_GEN_FAR} levels (bound {TP_GEN_FAR_SHARE}), at most {same['edited_level']}; phase "
              f"wall {time.perf_counter() - t0:.1f} s; on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {}
    for part in ("a", "b", "c"):
        for shape, n in recs[0][part]["shapes"].items():
            launched[shape] = launched.get(shape, 0) + n
    return {"k7_shapes": launched, "k7_launches": sum(launched.values())}


# Phase 25, the viewer on a mesh of ranks (signerf_tpu_torch/interface/
# channel.py): the train CLI's viewer (`train.parse`, `train._run`, no
# --train-only, no --skip-interface) on 14c's scene and checkpoint, rank 0
# serving on a port of its own with a client thread there driving every
# route, the other rank following rank 0's commands. (a) (data, tensor) =
# (2, 1) and (b) (1, 2), two ranks (gloo on cuda:0 on one card, NCCL a card
# a rank on more); (c) on four cards or more, (W, 1) at phase 14f's
# settings, its /generate against 14f's one-rank wall.
VR_MESHES = ((2, 1), (1, 2))  # (data, tensor)
VR_SIZES = (128, 512)
VR_REPEATS = 3  # timed paused /render requests a size, after one warm-up
VR_RAYS = 2 * TRAIN_RAYS  # global rays a step: phase 7's N on each of the two ranks
VR_STEPS = EDIT_STEPS  # refinement steps of /generate, 12 calls of 25
VR_QUIET_FROM = 25  # refinement steps from here on are timed, without a client until half-way
VR_DIFFUSION_STEPS = 2  # /params num_inference_steps: 1 sampler step at strength 0.9 (TP over gloo is slow)
VR_JOIN_S = 900.0
VR_MIN_CARDS_FOR_C = 4
VR_WORD_PROBES = 50  # empty control words back to back after the run: a word's own cost


def params_digest(torch, model) -> str:
    """sha256 of every parameter and buffer's bytes, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def viewer_ranks_client(torch, server, trainer, ffc, plan: dict) -> dict:
    """Phase 25's client on rank 0's host: every route, in order. Raises on
    a reply it does not expect; returns the timings and the launches rank 0
    made for its own requests (which no other rank makes)."""
    import urllib.error

    from signerf_tpu_torch.utils.images import decode_png

    base = f"http://127.0.0.1:{server.port_bound}"
    rec = {"render_chunks": 0}

    def chunks_of(size: int) -> int:
        return -(-(size * size) // CHUNK)

    def exact(label, before, want):
        got = count_delta(counts(ffc), before)
        if got != want:
            raise AssertionError(f"{label}: rank 0 launched {got}, expected {want}")

    http_post(base + "/params", {"num_inference_steps": plan["diffusion_steps"]} if plan["diffusion_steps"] else {})
    try:
        http_post(base + "/nudge", {"element": "nope"})
        rec["bad_nudge"] = 200
    except urllib.error.HTTPError as err:
        rec["bad_nudge"] = err.code
    if rec["bad_nudge"] != 400 or http_post(base + "/nudge", plan["ring"]) != {"ok": True}:
        raise AssertionError(f"a bad /nudge gave {rec['bad_nudge']} (400 expected), or the next one failed")

    paused = {}
    for size in VR_SIZES:
        rows = []
        for rep in range(VR_REPEATS + 1):
            before = counts(ffc)
            t0 = time.perf_counter()
            headers, body = http_get(f"{base}/render?{VIEWER_VIEW}&size={size}")
            wall = time.perf_counter() - t0
            rec["render_chunks"] += chunks_of(size)
            if decode_png(body).shape != (size, size, 3):
                raise AssertionError(f"paused /render at {size} px gave {decode_png(body).shape}")
            exact(f"paused /render at {size} px", before, expect_counts(K1=3)(chunks_of(size)))
            if rep:
                rows.append((wall * 1e3, server_timing(headers)))
        paused[size] = rows
    scene = json.loads(http_get(base + "/scene")[1])
    if len(scene["reference_poses"]) != EDIT_REFERENCES or len(scene["train_poses"]) != SCENE["cameras"]:
        raise AssertionError(f"/scene: {len(scene['reference_poses'])} references, {len(scene['train_poses'])} views")

    frame_chunks = chunks_of(SCENE["width"])
    before = counts(ffc)
    t0 = time.perf_counter()
    sheets = http_post(base + "/preview", {})
    rec["preview_s"] = time.perf_counter() - t0
    got = count_delta(counts(ffc), before)
    if got["K1"] != 3 * frame_chunks * EDIT_REFERENCES or set(sheets) != {"image", "mask", "condition", "edited"}:
        raise AssertionError(f"/preview: rank 0 launched {got}, sheets {sorted(sheets)}")

    steps = plan["steps"]
    client_from, client_to = (steps // 2, steps - 25) if plan["client"] else (steps, steps)
    gen = trainer.pipeline.dataset_generator  # /generate's (the exchange builds another)
    t0 = time.perf_counter()
    if http_post(base + "/generate", {}) != {"started": True}:
        raise AssertionError("/generate did not start")
    while trainer.step < client_from and not server._generation.done():
        time.sleep(0.05)
    rec["client_from"] = trainer.step
    replies, pause = [], None
    while trainer.step < client_to and not server._generation.done():
        t_req = time.perf_counter()
        headers, body = http_get(f"{base}/render?{VIEWER_VIEW}&size=512")
        size = decode_png(body).shape[0]
        rec["render_chunks"] += chunks_of(size)
        replies.append((size, (time.perf_counter() - t_req) * 1e3, server_timing(headers)))
        if len(replies) == 2 and pause is None:
            if http_post(base + "/train", {"state": "paused"}) != {"training_state": "paused"}:
                raise AssertionError("/train paused")
            held_from, t_pause = trainer.step, time.perf_counter()
            time.sleep(1.5)
            held = json.loads(http_get(base + "/state")[1])
            http_post(base + "/train", {"state": "training"})
            pause = (held_from, held["step"], held["training_state"], time.perf_counter() - t_pause)
            if pause[:3] != (held_from, held_from, "paused"):
                raise AssertionError(f"a paused refinement went on: {pause}")
        time.sleep(max(0.0, 1.0 / VIEWER_CLIENT_FPS - (time.perf_counter() - t_req)))
    rec["client_to"] = trainer.step
    server._generation.result(timeout=VR_JOIN_S)
    rec["generate_s"] = time.perf_counter() - t0
    end = json.loads(http_get(base + "/state")[1])
    if (end["training_state"], end["step"]) != ("completed", steps) or (plan["client"] and pause is None):
        raise AssertionError(f"/generate ended at {end['training_state']}, step {end['step']}; pause {pause}")
    _, _, coverage = check_generated(Path(trainer.config.pipeline.datamanager.dataparser.data), gen,
                                     SCENE["cameras"], f"phase 25{plan['label']} /generate")
    rec.update(replies=replies, pause=pause, paused=paused, coverage=coverage, timings=dict(gen.last_timings))

    before = counts(ffc)
    t0 = time.perf_counter()
    mesh = http_post(base + "/export", {"kind": "mesh", "resolution": EDIT_MESH_RESOLUTION, "iso": EDIT_MESH_ISO})
    rec["mesh_s"] = time.perf_counter() - t0
    rec["mesh_calls"] = -(-((EDIT_MESH_RESOLUTION + 1) ** 3) // (1 << 16))
    exact("/export mesh", before, expect_counts(K1=1)(rec["mesh_calls"]))
    before = counts(ffc)
    t0 = time.perf_counter()
    cloud = http_post(base + "/export", {"kind": "pointcloud"})
    rec["cloud_s"] = time.perf_counter() - t0
    # every camera of the generated dataset (the references and the views)
    rec["cloud_chunks"] = trainer.pipeline.datamanager.num_images * chunks_of(SCENE["width"] // 4)
    exact("/export pointcloud", before, expect_counts(K1=3)(rec["cloud_chunks"]))
    if mesh.get("faces", 0) <= 0 or cloud.get("points", 0) <= 0:
        raise AssertionError(f"/export: mesh {mesh}, point cloud {cloud}")
    before = counts(ffc)
    img = decode_png(http_get(f"{base}/render?{VIEWER_VIEW}&size=128")[1])
    rec["render_chunks"] += chunks_of(128)
    exact("/render after /generate", before, expect_counts(K1=3)(chunks_of(128)))
    if img.shape != (128, 128, 3):
        raise AssertionError(f"/render after /generate: {img.shape}")
    return rec


def viewer_ranks_rank(mesh, argv, out: str, plan: dict) -> int:
    """Phase 25 on one rank: the train CLI's work (`train.parse`,
    `train._run`) with its viewer on port 0; on rank 0 the client
    (`viewer_ranks_client`) in a thread, which closes the viewer's channel
    at its end. This rank's launches (zeroed before `_run`), K7's by shape
    against the pipeline's schedule, CUDA events at each step's loss,
    control words, parameter digests at the pause and the end and peak
    memory; rank 0 writes every rank's record."""
    import threading
    import traceback

    import torch

    from signerf_tpu_torch import pipeline as tpipe
    from signerf_tpu_torch import train as cli
    from signerf_tpu_torch.diffusion import unet as unet_mod
    from signerf_tpu_torch.engine import train_step as tts
    from signerf_tpu_torch.engine import trainer as ttrainer
    from signerf_tpu_torch.interface import app
    from signerf_tpu_torch.ops import flash_attention as fa
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    events, calls, shapes, servers, trainers, channels, pauses = [], [], {}, [], [], [], []
    real = dict(loss=tts.default_loss_fn, flash=unet_mod.flash_attention, diffuser=tpipe.Diffuser,
                setup=ttrainer.SIGNeRFTrainer.setup, run_interface=app.run_interface, command=app.run_command,
                start=app.ViewerServer.start_background, channel=app.CommandChannel)

    def recording_loss(model, outputs, batch):
        total, ld = real["loss"](model, outputs, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return total, ld

    def recording_flash(q, k, v, scale):
        key = tuple(q.shape[:3])
        shapes[key] = shapes.get(key, 0) + 1
        return real["flash"](q, k, v, scale)

    def make_diffuser(config, device=None, mesh=None):
        return recording_diffuser(real["diffuser"](config, device=device, mesh=mesh), calls)

    def setup(self, *a, **k):
        trainers.append(self)
        return real["setup"](self, *a, **k)

    def run_interface(trainer, port=VIEWER_PORT):
        return real["run_interface"](trainer, port=0)

    def run_command(interface, name, args, kwargs):
        result = real["command"](interface, name, args, kwargs)
        if name == "train" and args[0] == "paused":
            pauses.append((interface.trainer.step, params_digest(torch, interface.trainer.pipeline.model)))
        return result

    def start_background(self):
        httpd = real["start"](self)
        self.port_bound = httpd.server_address[1]
        servers.append(self)
        return httpd

    def channel(*a, **k):
        channels.append(real["channel"](*a, **k))
        return channels[-1]

    client: dict = {}

    def drive():
        try:
            deadline = time.perf_counter() + 300
            while not servers and time.perf_counter() < deadline:
                time.sleep(0.05)
            client.update(viewer_ranks_client(torch, servers[0], trainers[0], ffc, plan))
        except BaseException:  # noqa: BLE001 - the main process fails the phase with it
            client["error"] = traceback.format_exc()
        finally:
            if servers:
                servers[0].channel.close()

    _, _, config, train_only = cli.parse(argv)
    tts.default_loss_fn, unet_mod.flash_attention, tpipe.Diffuser = recording_loss, recording_flash, make_diffuser
    ttrainer.SIGNeRFTrainer.setup, app.run_interface, app.run_command = setup, run_interface, run_command
    app.ViewerServer.start_background, app.CommandChannel = start_background, channel
    torch.cuda.reset_peak_memory_stats(mesh.device)
    zero_counts(ffc)
    fa.launches = 0
    thread = threading.Thread(target=drive, daemon=True) if mesh.is_main else None
    try:
        if thread is not None:
            thread.start()
        t0 = time.perf_counter()
        rc = cli._run(mesh, config, mesh.device, train_only)
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
    finally:
        tts.default_loss_fn, unet_mod.flash_attention, tpipe.Diffuser = real["loss"], real["flash"], real["diffuser"]
        ttrainer.SIGNeRFTrainer.setup, app.run_interface = real["setup"], real["run_interface"]
        app.run_command, app.ViewerServer.start_background = real["command"], real["start"]
        app.CommandChannel = real["channel"]
    if thread is not None:
        thread.join(60)
    # A word's own cost: the ranks left the viewer together, so back-to-back
    # empty words on a fresh channel wait for no rank's other work.
    probe = real["channel"](mesh, lambda *a: None)
    for _ in range(VR_WORD_PROBES):
        probe.serve_once(block=False)
    object_ms = []  # the same empty word as a pickled object (two broadcasts), beside it
    for _ in range(VR_WORD_PROBES):
        t0 = time.perf_counter()
        mesh.broadcast_object(([], False), group=probe.group)
        object_ms.append((time.perf_counter() - t0) * 1e3)
    (trainer,) = trainers
    lo = trainer.pipeline.dataset_generator._layout()
    want_k7 = k7_launches(calls, lo.height, lo.width)
    if mesh.tensor > 1:
        want_k7 = tp_shapes(want_k7)
    bsz = trainer.config.pipeline.dataset_generator.generation_batch_size
    chunks = [list(range(s, min(s + bsz, SCENE["cameras"]))) for s in range(0, SCENE["cameras"], bsz)]
    rec = {"rank": mesh.rank, "device": str(mesh.device), "rc": rc, "wall_s": wall, "launches": counts(ffc),
           "k7": fa.launches, "k7_shapes": dict(shapes), "k7_expected": want_k7, "pauses": pauses,
           "digest": params_digest(torch, trainer.pipeline.model), "step": trainer.step,
           "step_ms": [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))],
           "words": channels[0].words, "word_ms": [s * 1e3 for s in channels[0].word_s],
           "probe_word_ms": [s * 1e3 for s in probe.word_s], "object_word_ms": object_ms,
           "view_group": mesh.view_group, "my_views": sum(len(c) for c in chunks[mesh.view_group::mesh.view_groups]),
           "served": len(servers), "client": client, "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30}
    records = mesh.gather_objects(rec)
    if mesh.is_main:
        torch.save({"backend": mesh.backend, "world": mesh.world_size, "tensor": mesh.tensor, "ranks": records},
                   Path(out))
    return 0


def viewer_ranks_run(torch, card: str, ref: dict, tmp: Path, shape, plan: dict, label: str) -> dict:
    """One viewer on a (data, tensor) = `shape` mesh (phase 25(a), (b) or
    (c)): spawn its ranks, check every record, print its figures. Returns
    rank 0's kernel work."""
    import numpy as np

    from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig, parse_transforms
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    cards = torch.cuda.device_count()
    ranks = shape[0] * shape[1]
    backend = "nccl" if cards >= ranks else "gloo"
    parsed = parse_transforms(SIGNeRFDataParserConfig(data=ref["data"]))
    corners = to_world(parsed, list(itertools.product(*zip(*SHEET_AABB_SCENE))))
    run_dir = tmp / label.strip("()")
    argv = ["signerf_nerfacto", "--data", str(ref["data"]), "--load-dir", str(ref["ckpt_dir"]), "--device", "cuda",
            "--mesh", f"data={shape[0]},tensor={shape[1]}", "--output-dir", str(run_dir), "--max-num-iterations",
            str(plan["steps"]), "--steps-per-save", str(plan["steps"]), "--pipeline.datamanager.train-num-rays-per-batch",
            str(plan["rays"]), "--pipeline.dataset-generator.path", str(run_dir / "generations"),
            "--pipeline.dataset-generator.aabb-min", json.dumps(corners.min(0).tolist()),
            "--pipeline.dataset-generator.aabb-max", json.dumps(corners.max(0).tolist()), *REFERENCE_FLAGS]
    # the interface's default ring (radius 1, world origin) moved onto 14c's
    # reference ring: the scene's centre, radius 2 in the scene's frame
    plan = dict(plan, label=label, ring={"element": "reference", "translate": to_world(parsed, [0.0, 0.0, 0.0]).tolist(),
                            "scale": float(EDIT_REFERENCE_RING["radius"] * parsed.dataparser_scale)})
    out = run_dir / "records.pt"
    run_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        mesh_lib.spawn(viewer_ranks_rank, (argv, str(out), plan), ranks, run_dir, device_type="cuda",
                       backend=backend, cards=min(cards, ranks), join_timeout_s=VR_JOIN_S, tensor=shape[1])
    except Exception as exc:  # a rank failed: its error is above
        fail(f"phase 25{label}: a rank failed: {exc!r}")
    spawn_s = time.perf_counter() - t0
    res = torch.load(out, weights_only=False)
    recs = res["ranks"]
    c = recs[0]["client"]
    if "error" in c:
        fail(f"phase 25{label}: the client on rank 0 failed:\n{c['error']}")
    if (res["backend"], res["world"], res["tensor"]) != (backend, ranks, shape[1]):
        fail(f"phase 25{label}: {res['world']} ranks over {res['backend']}, tensor {res['tensor']}")
    frame = -(-(SCENE["width"] * SCENE["height"]) // CHUNK)
    steps = plan["steps"]
    for r in recs:
        views = (2 * EDIT_REFERENCES if r["view_group"] == 0 else 0) + r["my_views"]
        want = expect_counts(K1=3, K2_tables=3)(steps)
        want["K1"] += 3 * frame * views
        if r["rank"] == 0:
            want["K1"] += 3 * (c["render_chunks"] + c["cloud_chunks"]) + c["mesh_calls"]
        bad = []
        if r["rc"] != 0 or r["served"] != (r["rank"] == 0) or r["step"] != steps:
            bad.append(f"rc {r['rc']}, served {r['served']}, step {r['step']}")
        if r["launches"] != want:
            bad.append(f"launches {r['launches']}, expected {want}")
        if r["k7_shapes"] != r["k7_expected"] or r["k7"] != sum(r["k7_expected"].values()):
            bad.append(f"K7 {r['k7']} {r['k7_shapes']}, the schedule {r['k7_expected']}")
        if r["digest"] != recs[0]["digest"] or r["pauses"] != recs[0]["pauses"] or r["words"] != recs[0]["words"]:
            bad.append(f"parameters or pauses differ from rank 0's: {r['pauses']} against {recs[0]['pauses']}, "
                       f"words {r['words']} against {recs[0]['words']}")
        if bad:
            fail(f"phase 25{label} rank {r['rank']}: " + "; ".join(bad))

    def ms_line(xs):
        return f"{median(xs):.3f} ({min(xs):.3f} to {max(xs):.3f})" if xs else "none"

    lat = "; ".join(
        f"{size} px: request {ms_line([x[0] for x in rows])}, lock {ms_line([x[1]['lock'] for x in rows])}, render "
        f"{ms_line([x[1]['render'] for x in rows])}, PNG {ms_line([x[1]['png'] for x in rows])}"
        for size, rows in c["paused"].items())
    windows = []
    for r in recs:
        quiet = r["step_ms"][VR_QUIET_FROM:c["client_from"] - 1]
        busy = r["step_ms"][c["client_from"]:c["client_to"] - 1]
        windows.append(f"rank {r['rank']} {ms_line(quiet)} ms without a client (steps {VR_QUIET_FROM} to "
                       f"{c['client_from']}), {ms_line(busy)} ms with one (steps {c['client_from']} to {c['client_to']})")
    sizes = [x[0] for x in c["replies"]]
    launches = "; ".join(f"rank {r['rank']}: " + ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v)
                         + f", K7 {r['k7']}" for r in recs)
    t = c["timings"]
    print(f"phase 25{label} the train CLI's viewer on (data, tensor) = {shape}, {ranks} ranks over {backend} on "
          f"{sorted({r['device'] for r in recs})}: rank 0 served and {ranks - 1} followed over {recs[0]['words']} control "
          f"words; a bad /nudge answered 400 and the next command ran; paused /render median (range) over "
          f"{VR_REPEATS} in ms: {lat}; /preview {c['preview_s']:.3f} s; /generate "
          f"{c['generate_s']:.3f} s to completed (sheet {t['sheet_s']:.3f} s, rank 0's chunks "
          + ", ".join(f"{x:.3f}" for x in t["view_s"]) + f" s, {steps} refinement steps of {plan['rays']} global rays; "
          f"mask coverage " + ", ".join(f"{x:.3f}" for x in c["coverage"]) + "); "
          f"refinement step median (range): " + "; ".join(windows)
          + f"; {len(sizes)} replies at " + ", ".join(f"{s} px x {sizes.count(s)}" for s in sorted(set(sizes)))
          + f" while training, request {ms_line([x[1] for x in c['replies']])} ms, lock wait "
          f"{ms_line([x[2]['lock'] for x in c['replies']])} ms, render {ms_line([x[2]['render'] for x in c['replies']])} "
          f"ms; paused at step {c['pause'][0] if c['pause'] else None} for "
          f"{c['pause'][3] if c['pause'] else 0.0:.3f} s, held on every rank; parameter digests equal on every rank at "
          f"the pause ({len(recs[0]['pauses'])}) and after the refinement; control word a train call (each rank's wait "
          f"for it and its broadcast, the later rank's is its cost): " + ", ".join(
              f"rank {r['rank']} {ms_line(r['word_ms'])} ms" for r in recs) + f" over {len(recs[0]['word_ms'])} calls, "
          f"alone ({VR_WORD_PROBES} empty words back to back) " + ", ".join(
              f"rank {r['rank']} {ms_line(r['probe_word_ms'])} ms" for r in recs) + " (as a pickled object: "
          + ", ".join(f"rank {r['rank']} {ms_line(r['object_word_ms'])} ms" for r in recs) + "); "
          f"/export mesh {c['mesh_s']:.3f} s, point cloud "
          f"{c['cloud_s']:.3f} s; launches by rank: {launches} (K1 on rank 0 alone for each /render: 3 x "
          f"{c['render_chunks']} chunks, and for the exports); peak memory "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in recs) + f" GiB; wall of the spawned ranks {spawn_s:.1f} s; on "
          f"{card}", flush=True)
    r0 = recs[0]
    mine = 2 * EDIT_REFERENCES + r0["my_views"]
    return {"chunks": c["render_chunks"] + c["cloud_chunks"] + frame * mine, "train_steps": steps,
            "mesh_calls": c["mesh_calls"], "k7_shapes": r0["k7_shapes"], "k7_launches": r0["k7"],
            "generate_s": c["generate_s"]}


def phase_viewer_ranks(torch, card: str, ref: dict, one_rank: dict) -> dict:
    """Phase 25: the viewer on (2, 1) and (1, 2) (VR_MESHES) at VR_STEPS
    refinement steps of VR_RAYS and VR_DIFFUSION_STEPS, a client at
    VIEWER_CLIENT_FPS in the refinement's second half; on four cards or
    more also (W, 1) at phase 14f's settings against `one_rank` (14f's
    walls). Returns rank 0's kernel work over (a) and (b)."""
    cards = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_viewer_ranks_"))
    t0 = time.perf_counter()
    total = {"chunks": 0, "train_steps": 0, "mesh_calls": 0, "k7_shapes": {}, "k7_launches": 0}
    try:
        plan = {"steps": VR_STEPS, "rays": VR_RAYS, "diffusion_steps": VR_DIFFUSION_STEPS, "client": True}
        for shape, label in zip(VR_MESHES, ("(a)", "(b)")):
            got = viewer_ranks_run(torch, card, ref, tmp, shape, plan, label)
            for key in ("chunks", "train_steps", "mesh_calls", "k7_launches"):
                total[key] += got[key]
            for s, n in got["k7_shapes"].items():
                total["k7_shapes"][s] = total["k7_shapes"].get(s, 0) + n
        if cards >= VR_MIN_CARDS_FOR_C:
            plan = {"steps": EDIT_STEPS, "rays": TRAIN_RAYS, "diffusion_steps": EDIT_SDXL_STEPS, "client": False}
            got = viewer_ranks_run(torch, card, ref, tmp, (cards, 1), plan, "(c)")
            print(f"phase 25(c) /generate on {cards} cards {got['generate_s']:.3f} s against phase 14f's one rank "
                  f"{one_rank['generate_s']:.3f} s (ratio {got['generate_s'] / one_rank['generate_s']:.3f}); on {card}",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 25 wall {time.perf_counter() - t0:.1f} s; on {card}", flush=True)
    return total


def kernel_entry(name, source, line, launches, stats, ms_key="ms", plain_key="plain_ms", bound_key="",
                 replaces="signerf_tpu/ops/fused_factor_pallas.py"):
    return {
        "name": name,
        "route": "cuda",
        "source": f"signerf_tpu_torch/csrc/{source}",
        "replaces": f"{replaces}:{line}",
        "launches": stats["launches"] if launches is None else launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": stats[ms_key],
        "plain_ms": stats[plain_key],
        "bound_ms": stats[f"bound_ms{bound_key}"],
        "bound_by": stats[f"bound_by{bound_key}"],
        "library_ms": stats.get("library_ms"),
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import signerf_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the repository root: {exc}")

    t_start = time.perf_counter()
    walls, t_lap = [], [t_start]

    def lap(label: str) -> None:
        # the wall of the phase (or phases) that ran since the last lap
        now = time.perf_counter()
        walls.append(f"{label} {now - t_lap[0]:.1f}")
        t_lap[0] = now

    card = phase_environment(torch)
    phase_build()
    lap("1-2")
    k1 = phase_kernel(torch)
    lap("3")
    k2 = phase_k2(torch)
    lap("4")
    k36 = phase_k3_k6(torch)
    lap("5")
    k810 = phase_k8_k10(torch)
    lap("5b")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        data = write_scene(tmp / "scene")
        render_launches = phase_render(torch, card, data, tmp)
        lap("6")
        train = phase_train(torch, card, data, tmp, "signerf_nerfacto", TRAIN_STEPS, TRAIN_RAYS, 1,
                            NERFACTO_COUNTS, 7)
        lap("7")
        camopt = phase_camera_opt(torch, data, tmp, "signerf_nerfacto", CAMERA_OPT_STEPS,
                                  expect_counts(K1=3, K2_tables=3, K2_coords=3), 8)
        lap("8")
        phase_plain_step(torch, data)
        lap("9")
        phase_eval(torch, data, tmp, train["ckpt_dir"])
        lap("10")
        signerf = phase_train(torch, card, data, tmp, "signerf", SIGNERF_STEPS, SIGNERF_RAYS, SIGNERF_MICRO,
                              SIGNERF_COUNTS, 11)
        lap("11")
        signerf_camopt = phase_camera_opt(
            torch, data, tmp, "signerf", SIGNERF_CAMERA_OPT_STEPS,
            expect_counts(K1=8, K2_tables=8, K2_coords=8, K3=4, K4_tables=4, K4_coords=4, K5=4,
                          K6_tables=4, K6_coords=4), 12,
        )
        lap("12")
        phase_signerf_step(torch, data, signerf["ckpt_dir"])
        phase_profile(torch, card, data, signerf["ckpt_dir"])
        lap("13")
        evaluation = phase_signerf_eval(torch, data, signerf["ckpt_dir"])
        lap("14")
        grad_entry = phase_grad_entry_points(torch, card, data, signerf["ckpt_dir"])
        lap("14b")
        ref = phase_reference_sheet(torch, card, tmp, train["ckpt_dir"])
        lap("14c")
        edit = phase_edit_pass(torch, card, tmp, ref)
        lap("14d-e")
        viewer = phase_viewer(torch, card, tmp, ref)
        lap("14f")
        p25 = phase_viewer_ranks(torch, card, ref, viewer)
        lap("25")
        phase_hash(torch, card, data, tmp, ref)
        lap("14g")
        last = phase_last_modules(torch, card, data, tmp, ref, train)
        lap("21(a-d, g, h)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k7 = phase_k7(torch, card)
    lap("15")
    sheet = phase_sheet(torch, card, ref)
    lap("16")
    phase_per_view(torch, card, sheet)
    lap("17")
    eps_one = phase_cfg_branch(torch, card, sheet)
    lap("18")
    phase_diffusion_profile(torch, card, sheet)
    lap("19")
    tp_in = tp_inputs(ref, sheet)
    tp_ref = phase_tp_reference(torch, card, sheet, tp_in)
    lap("24's one-rank reference")
    last_sdxl = phase_last_sdxl(torch, card, sheet)
    lap("21(e, f)")
    sheet["diffuser"]._sdxl = None  # phase 22 creates its own
    p22 = phase_scripts(torch, card)
    lap("22")
    one_root = Path(tempfile.mkdtemp(prefix="chip_smoke_one_"))
    try:
        p23 = phase_data_parallel(torch, card, one_root)
        lap("23")
        p24 = phase_tensor_parallel(torch, card, tp_in, eps_one, tp_ref, one_root)
        lap("24")
    finally:
        shutil.rmtree(one_root, ignore_errors=True)
    launched = signerf["launches"]
    # K3, K4's and K6's tables halves and K5 once a micro-batch (phase 23:
    # rank 0's micro-batches, the launches this process counted); phase 22's
    # pretrain runs `pre` micro-batches of 16,384 rays, at the shapes of
    # `pre_calls`
    ns_train = p22["micro"] + p23["micro"]
    pre, pre_calls = p22["pre_micro"], p22["pre_calls"]
    pre_err = pre_calls["max_abs_err"]
    # Calls of each field at a render chunk's and a train step's N in phases
    # 6, 7, 11, 14, the edit pass (14d, 14e), the viewer (14f) and the
    # example scripts (22; the eval render and a `signerf` step call only the
    # proposal fields, the latter in each of its micro-batches), and the base
    # field's at the mesh export's N.
    chunks = (render_launches // 3 + edit["chunks"] + viewer["chunks"] + last["arc_chunks"] + p22["fit_chunks"]
              + p25["chunks"])
    steps = (train["launches"]["K1"] // 3 + edit["train_steps"] + viewer["train_steps"] + last["repeat_steps"]
             + p22["fit_steps"] + p25["train_steps"])
    eval_chunks = evaluation["K1"] // 2 + p22["eval_chunks"]
    micro = launched["K1"] // 2 + p22["micro"] + p23["micro"]
    fields = [(name, name != "final") for name, _, _ in TRAIN_SCHEDULES]
    k1_calls = [(chunks + eval_chunks * proposal, k1["per_call"][(name, "chunk")]) for name, proposal in fields]
    k1_calls += [(steps + micro * proposal, k1["per_call"][(name, "train")]) for name, proposal in fields]
    k1_calls += [(pre, pre_calls["K1"][name]) for name, proposal in fields if proposal]
    k1_calls += [(edit["mesh_calls"] + viewer["mesh_calls"] + p25["mesh_calls"], k1["per_call"][("final", "mesh")])]
    # Phase 21(a): the linear proposals' steps and chunks run K1 (and K2's
    # tables half) for the base field only, K3 (and K4's tables half) for
    # the proposal fields.
    linear, p21 = last["linear"], last["stats"]
    lin_steps = linear["train"]["launches"]["K1"]
    lin_chunks = (linear["views"] + linear["render_frames"]) * linear["chunks"]
    k1_calls += [(lin_steps, k1["per_call"][("final", "train")]), (lin_chunks, k1["per_call"][("final", "chunk")])]
    k2_tables = [(steps + micro * proposal, k2["per_call"][name]["tables"]) for name, proposal in fields]
    k2_tables += [(lin_steps, k2["per_call"]["final"]["tables"])]
    k2_tables += [(pre, pre_calls["K2 tables"][name]) for name, proposal in fields if proposal]
    k3_calls = [(launched["K3"] + ns_train, k36["K3"]), (evaluation["K3"] + p22["eval_chunks"], k36["K3"]["eval"]),
                (last["K3"], k36["K3"]), (pre, pre_calls["K3"])]
    k4_calls = [(launched["K4 tables"] + ns_train, k36["K4 tables"]), (last["K4 tables"], k36["K4 tables"]),
                (pre, pre_calls["K4 tables"])]
    for name, _, _ in PROPOSAL_FIELDS:
        k3_calls += [(lin_steps, p21[("K3", name, "train")]), (lin_chunks, p21[("K3", name, "chunk")])]
        k4_calls += [(lin_steps, p21[("K4 tables", name, "train")])]
    # K7 per call over the sheet inpaint's shapes (phase 16), the edit pass's,
    # the viewer's and phase 22's (14d, 14f, 22).
    k7_calls = {shape: 2 * n * (sheet["steps"] + last_sdxl["steps"]) for shape, n in K7_SHEET_CALLS.items()}
    for shape, n in itertools.chain(edit["k7_shapes"].items(), viewer["k7_shapes"].items(),
                                    p22["k7_shapes"].items(), p24["k7_shapes"].items(), p25["k7_shapes"].items()):
        k7_calls[shape] = k7_calls.get(shape, 0) + n
    if set(k7_calls) - set(k7["per_shape"]):
        fail(f"K7 ran at shapes phase 15 did not time: {sorted(set(k7_calls) - set(k7['per_shape']))}")
    k7_stats = per_call("K7", [(n, k7["per_shape"][shape]) for shape, n in k7_calls.items()], k7["max_abs_err"])
    k7_counted = (sheet["launches"] + edit["k7_launches"] + viewer["k7_launches"] + last_sdxl["k7_launches"]
                  + p22["k7_launches"] + p24["k7_launches"] + p25["k7_launches"])
    if k7_stats["launches"] != k7_counted:
        fail(f"K7: {k7_stats['launches']} launches weighted, {k7_counted} counted")
    k2_coords = [(camopt["K2 coords"] // 3, k2["per_call"][name]["coords"]) for name, _ in fields]
    kernels = [
        kernel_entry("fused_factor_density (per call)", "fused_factor_density.cu", 1475, None,
                     per_call("K1", k1_calls, max(k1["max_abs_err"], pre_err["K1"]))),
        kernel_entry("fused_factor_density_bwd (tables and MLP half, per call)", "fused_factor_density_bwd.cu", 1686,
                     None, per_call("K2 tables half", k2_tables, max(k2["max_abs_err"], pre_err["K2 tables"]))),
        kernel_entry("fused_factor_density_bwd (coords half, per call)", "fused_factor_density_bwd.cu", 1776, None,
                     per_call("K2 coords half", k2_coords, k2["max_abs_err"])),
        kernel_entry("fused_factor_encode (per call)", "fused_factor_encode.cu", 196, None,
                     per_call("K3", k3_calls, max(k36["K3"]["max_abs_err"], p21["max_abs_err"]["K3"],
                                                  pre_err["K3"]))),
        kernel_entry("fused_factor_encode_bwd (tables half, per call)", "fused_factor_encode.cu", 626, None,
                     per_call("K4 tables half", k4_calls, max(k36["K4 tables"]["max_abs_err"],
                                                              p21["max_abs_err"]["K4 tables"], pre_err["K4 tables"]))),
        kernel_entry("fused_factor_encode_bwd (coords half)", "fused_factor_encode.cu", 640,
                     signerf_camopt["K4 coords"], k36["K4 coords"]),
        kernel_entry("fused_factor_grad_dot", "fused_factor_grad_dot.cu", 1037, None,
                     per_call("K5", [(launched["K5"] + ns_train, k36["K5"]),
                                     (evaluation["K5"] + p22["eval_chunks"], k36["K5"]["eval"]),
                                     (pre, pre_calls["K5"])],
                              max(k36["K5"]["max_abs_err"], pre_err["K5"]))),
        kernel_entry("fused_factor_grad_dot_bwd (tables half and grad_g, per call)", "fused_factor_grad_dot.cu", 1315,
                     None, per_call("K6 tables half", [(launched["K6 tables"] + ns_train, k36["K6 tables"]),
                                                       (pre, pre_calls["K6 tables"])],
                                    max(k36["K6 tables"]["max_abs_err"], pre_err["K6 tables"]))),
        kernel_entry("fused_factor_grad_dot_bwd (coords half)", "fused_factor_grad_dot.cu", 1329,
                     signerf_camopt["K6 coords"], k36["K6 coords"]),
        kernel_entry("flash_attention (per call)", "flash_attention.cu", 216, None, k7_stats,
                     replaces="signerf_tpu/diffusion/unet.py"),
        kernel_entry("fused_factor_grad", "fused_factor_grad.cu", 399, grad_entry["K8"] + last["K8"], k810["K8"]),
        kernel_entry("fused_factor_grad_bwd (tables half)", "fused_factor_grad.cu", 902,
                     grad_entry["K9 tables"] + last["K9 tables"], k810["K9 tables"]),
        kernel_entry("fused_factor_grad_bwd (coords half)", "fused_factor_grad.cu", 916, grad_entry["K9 coords"],
                     k810["K9 coords"]),
        kernel_entry("factor_dense_encode (factor_encode_pallas)", "fused_factor_encode.cu", 79, grad_entry["K10"],
                     k810["K10"], replaces="signerf_tpu/ops/pallas/factor_grid_kernel.py"),
    ]
    print(f"phase 20 walls in run order, s: {'; '.join(walls)}", flush=True)
    print(f"phase 20 smoke wall {time.perf_counter() - t_start:.1f} s, the build included; on {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
