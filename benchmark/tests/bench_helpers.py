"""Shared set-up of the benchmark's CPU tests: the benchmark on the path and
tiny sizes for its drivers (the fields' widths as configured, few samples
a ray, a few small views)."""

from __future__ import annotations

import sys
import types
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (ROOT, BENCH_DIR):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_MODEL = dict(num_proposal_samples_per_ray=[32, 16], num_nerf_samples_per_ray=8)
TINY_TRAIN = dict(views=3, size=48, rays=1024, sync_every=1, reference_block_rays=1024, trace_after_s=0.2,
                  trace_steps=1)
TINY_RENDER = dict(views=3, frame_size=24, chunk_size=192, check_frames=2, check_within=3, trace_after_s=0.2, trace_frames=1,
                   reference_block_rays=192)


def hooks(**kw) -> types.SimpleNamespace:
    """A driver's test settings: the CPU, tiny sizes, the readings kept."""
    base = dict(device="cpu", model=dict(TINY_MODEL), readings={})
    base.update(kw)
    return types.SimpleNamespace(**base)
