"""Timing on the card: CUDA events around warm repeats, and a breakdown of
device time by kernel under `torch.profiler`.

The port's counterpart of `signerf_tpu/utils/microbench.py`. The JAX module
differences `lax.scan` lengths to cancel a remote device's round trip and
the fetch that waits for it. On a local card CUDA events recorded on the
stream around K calls, after a warm-up, time the device's work directly:
the host's launch time is inside the window only where the device waits on
it, which is what the caller pays.

Every function needs an NVIDIA GPU. Without one it raises: a host clock
around asynchronous work measures the enqueue, and a CPU run says nothing
about the card, so nothing here falls back to wall-clock time on the CPU.
Like `scan_time`, a time that cannot be resolved is NaN, never a negative
number; callers that publish times drop or label NaN rows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from signerf_tpu_torch.utils import tracing

# [(group, (substring, ...)), ...]: a kernel whose lower-cased name contains
# one of a group's substrings is the first such group's; the rest is "other".
Groups = Sequence[Tuple[str, Sequence[str]]]

# The port's factor-grid kernels and the LPIPS convolutions of a train step,
# by substrings of their names (a renamed kernel is renamed here too).
TRAIN_KERNEL_GROUPS: Groups = [
    ("K1", ("density_kernel",)),
    ("K2", ("density_bwd_tables_kernel", "density_bwd_coords_kernel")),
    ("K3", ("encode_kernel",)),
    ("K4", ("encode_bwd_tables_kernel", "encode_bwd_dot_kernel")),
    ("K5", ("grad_dot_kernel",)),
    ("K6", ("grad_dot_bwd_tables_kernel", "grad_dot_bwd_coords_kernel")),
    ("LPIPS convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit_gemm", "winograd", "fft")),
]


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "signerf_tpu_torch.utils.microbench times work on an NVIDIA GPU and torch sees none; "
            "it does not fall back to the CPU's clock"
        )


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    require_cuda()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _positive(ms: float) -> float:
    return ms if math.isfinite(ms) and ms > 0 else float("nan")


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device ms per call of `fn` over `iters` calls after one warm-up
    call: one pair of CUDA events around the loop. NaN if unresolved."""
    require_cuda()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return _positive(start.elapsed_time(end) / iters)


@dataclasses.dataclass
class CudaTiming:
    """ms per call over `repeats` windows of `iters` calls each."""

    median_ms: float  # NaN if a window could not be resolved
    min_ms: float
    max_ms: float
    repeats: int
    iters: int

    @property
    def resolved(self) -> bool:
        return math.isfinite(self.median_ms)


def cuda_time_stats(fn: Callable[[], object], iters: int = 10, repeats: int = 5, warmup: int = 1) -> CudaTiming:
    """`warmup` calls, then `repeats` windows of `iters` calls, each between
    its own pair of CUDA events: the median ms per call and its range."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(_positive(s.elapsed_time(e) / iters) for s, e in pairs)
    if any(math.isnan(x) for x in ms):
        return CudaTiming(float("nan"), float("nan"), float("nan"), repeats, iters)
    return CudaTiming(ms[len(ms) // 2], ms[0], ms[-1], repeats, iters)


def kernel_breakdown(fn: Callable[[], object], groups: Groups, iters: int = 1, warmup: int = 1) -> Dict:
    """`fn` run `iters` times under `torch.profiler` after `warmup` calls.

    Returns, per call: `span_ms` (CUDA events around the profiled calls, so
    it carries the profiler's own host cost), `groups_ms` (device ms of each
    group's kernels, then "other"), `kernels_ms` (device ms by kernel name),
    `busy_ms` (their sum), the device's `busy_share` and `idle_share` of
    the span, and `spans`, the program's spans (`utils/tracing.summary()`)
    recorded in the profiled calls, each with its `device_ms`: the kernels
    launched inside it (`span_device_ms`). Device time is summed over the
    trace's CUDA events, not over `key_averages()`, whose operator rows
    carry their kernels' time again.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    tracing.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / iters
    kernels: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    grouped = {name: 0.0 for name, _ in groups}
    grouped["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in groups if any(k in low for k in keys)), "other")
        grouped[group] += ms
    busy = sum(kernels.values())
    if not busy > 0:
        raise RuntimeError("the profiler saw no device time")
    share = busy / span_ms if span_ms > 0 else float("nan")
    recorded = tracing.summary()["spans"]
    device = span_device_ms(prof.events(), recorded)
    spans = {name: {**{k: None if v is None else v / iters for k, v in s.items()}, "device_ms": device[name] / iters}
             for name, s in recorded.items()}
    return {"span_ms": _positive(span_ms), "groups_ms": grouped, "kernels_ms": kernels, "busy_ms": busy,
            "busy_share": share, "idle_share": 1.0 - share, "iters": iters, "spans": spans}


def span_device_ms(events, names) -> Dict[str, float]:
    """Device ms of the kernels launched inside each named span of a trace.

    A kernel is a span's when the host operation that launched it (the one
    the profiler links it to) starts inside one of the span's ranges, on
    any thread: autograd's backward thread launches the backward's kernels
    while the thread that called ``backward()`` waits inside its span. A
    kernel counts for every span around it. Unlike a span's CUDA events,
    this leaves out the time the stream waits for the host.
    """
    from torch.autograd import DeviceType

    ranges: Dict[str, List[Tuple[float, float]]] = {name: [] for name in names}
    launches: List[Tuple[float, float]] = []  # (host start, device us)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        if e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
        if e.kernels:
            launches.append((e.time_range.start, sum(k.duration for k in e.kernels)))
    return {name: sum(us for t, us in launches if any(a <= t <= b for a, b in spans)) / 1e3
            for name, spans in ranges.items()}


class Stages:
    """Named per-call times for a breakdown file: each stage's median ms over
    the repeats and its range; a stage that cannot be resolved is listed
    under `unresolved`, never as a time."""

    def __init__(self):
        self.ms: Dict[str, float] = {}
        self.range_ms: Dict[str, List[float]] = {}
        self.unresolved: List[str] = []

    def time(self, label: str, fn: Callable[[], object], iters: int = 10, repeats: int = 5) -> float:
        t = cuda_time_stats(fn, iters, repeats)
        if t.resolved:
            self.ms[label] = round(t.median_ms, 4)
            self.range_ms[label] = [round(t.min_ms, 4), round(t.max_ms, 4)]
            print(f"  {label}: {t.median_ms:.4f} ms ({t.min_ms:.4f} to {t.max_ms:.4f})", flush=True)
        else:
            self.unresolved.append(label)
            print(f"  {label}: unresolved", flush=True)
        return t.median_ms

    def as_dict(self) -> Dict:
        out = {"stages_ms": self.ms, "stages_range_ms": self.range_ms}
        if self.unresolved:
            out["unresolved"] = self.unresolved
        return out


def write_breakdown(path, results: Dict, script: str, note: str) -> None:
    """`results` with the card, the software and the method, as JSON."""
    out = {"script": script, "date": time.strftime("%Y-%m-%d"), "hardware": card_name(),
           "torch": torch.__version__, "cuda": torch.version.cuda, **results, "note": note}
    Path(path).write_text(json.dumps(out, indent=2))
    print(f"wrote {path}", flush=True)
