"""Device time from `torch.profiler`: time by kernel, the busy union, the
longest idle gaps by what the host was doing, and the benchmark's own
spans.

Device time is summed over the trace's CUDA events (not `key_averages()`,
whose operator rows carry their kernels' time again), and the busy time is
the union of the kernels' intervals, so kernels on two streams at once are
counted once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

from harness import peaks


@dataclasses.dataclass
class TraceSummary:
    units: int  # steps, frames or views profiled
    window_s: float  # host time from the first call to the final synchronise
    busy_s: float  # union of the device intervals
    kernels_s: Dict[str, float]  # device seconds by kernel name, whole window
    groups_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]

    def per_unit_ms(self, group: str) -> float:
        return 1e3 * self.groups_s.get(group, 0.0) / self.units

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernels_s.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def profile(torch, call: Callable[[int], None], units: int) -> TraceSummary:
    """`call(i)` for i < units under the profiler, then a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            call(i)
        sync()
        window = time.perf_counter() - t0
    kernels: Dict[str, float] = {}
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + tr.elapsed_us() / 1e6
            dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    merged = _union(dev)
    busy = sum(e - s for s, e in merged) / 1e6
    return TraceSummary(units=units, window_s=window, busy_s=busy, kernels_s=kernels,
                        groups_s={g: ms / 1e3 for g, ms in peaks.group_ms({k: v * 1e3 for k, v in kernels.items()}).items()},
                        idle_gaps=_name_gaps(merged, host))


def _name_gaps(merged, host, longest: int = 500) -> List[Tuple[str, float]]:
    """The idle gaps between device intervals, each named by the innermost
    host operation that spans its middle; the `longest` gaps, summed by
    name, the ten largest sums."""
    import numpy as np

    gaps = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _) in zip(merged[:-1], merged[1:])), reverse=True)
    if not host:
        return []
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    out: Dict[str, float] = {}
    for length, mid in gaps[:longest]:
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size else "(no host op)"
        out[name] = out.get(name, 0.0) + length / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
