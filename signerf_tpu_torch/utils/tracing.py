"""Spans and counters inside the port, on the profiler's clock.

A span marks a layer's boundary: ``with span("engine.step"): ...``. It
records only while `torch.profiler` records on the calling thread (the
benchmark's traced window, `utils/microbench.kernel_breakdown`, the
`scripts/profile_*_torch.py` scripts); otherwise it costs one call of the
profiler's flag and nothing else. While on, a span

- enters a profiler range of its name (function scope, as an operator's),
  so it is a host range of the same trace as the kernels, on the same
  clock: an idle gap of the device is named by the innermost span over it;
- appends a record (name, parent, unit, thread, host ns at enter and exit)
  to an in-memory list of at most `CAP` records, and counts what it drops;
- with ``stream=True``, records a pair of CUDA events on the current stream
  (when the process uses CUDA), read only when `summary()` is taken. Their
  interval is the stream's from one end of the span to the other: the
  span's kernels and whatever time the stream waits for the host between
  them. It is the span's device time only while the host keeps ahead of
  the card; the profiler slows the host, and the interval then follows the
  host's pace. `microbench.kernel_breakdown` gives a span's device time
  from the trace's kernels.

Parents are per thread, and so are units: a span opened on a thread with no
open span starts a unit (a step, a frame). No span of the program runs on
autograd's backward thread (one that did would start a unit of its own). A
unit snapshots `counters()` at enter and exit, so `summary()` gives each
counter's growth inside the recorded units; the counters themselves count
the whole process, set-up included.

The counters stay module globals beside their code, each added to once per
event it counts: `fused_factor_cuda`'s launches of K1 to K10,
`flash_attention.launches` (K7), `factor_grid.table_pack_bytes`, and the eval
render's chunks, graph replays and graph captures (`engine/chunk_graph.py`,
named `render.*`). A site adds `count(name)`: while its thread captures a
CUDA graph (`capturing`), which launches nothing, the events go to that
graph's own tally instead, and each replay of the graph, which launches
them, adds the tally (`add`). Other threads count as they go.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from types import ModuleType
from typing import Dict, Iterator, List, Optional, Tuple

import torch

CAP = 1 << 20  # records kept until `reset()`; later ones are counted as dropped

_profiling = torch._C._autograd._profiler_enabled  # true only on threads the profiler records
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open records (None for a dropped one)
_capture = threading.local()  # .tally: the counts of the graph this thread captures, if any
_records: List["_Record"] = []
_dropped = 0


class _Record:
    __slots__ = ("id", "name", "parent", "unit", "thread", "start_ns", "end_ns", "events", "counters")


@functools.cache
def _counters() -> Tuple[Tuple[str, ModuleType, str], ...]:
    """(name, module, attribute) of each of the port's counters."""
    from signerf_tpu_torch.engine import chunk_graph
    from signerf_tpu_torch.ops import factor_grid, flash_attention
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    return (*((f"fused_factor_cuda.{name}", ffc, name) for name in ffc.COUNTERS),
            ("flash_attention.launches", flash_attention, "launches"),
            ("factor_grid.table_pack_bytes", factor_grid, "table_pack_bytes"),
            *((f"render.{name}", chunk_graph, name) for name in chunk_graph.COUNTERS))


def counters() -> Dict[str, int]:
    """The port's counters now, by module and name."""
    return {name: getattr(module, attr) for name, module, attr in _counters()}


def count(name: str, n: int = 1) -> int:
    """What counter `name`'s site adds for `n` events: `n`, or 0 while this
    thread captures a CUDA graph (`capturing`), whose tally takes them."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        return n
    tally[name] = tally.get(name, 0) + n
    return 0


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Within, this thread's counts go to the yielded tally, by counter
    name, and not to the counters: the events a CUDA graph's capture records
    (`engine/chunk_graph.py`), which every replay adds (`add`)."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("this thread is capturing a graph already")
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def add(counts: Dict[str, int]) -> None:
    """Add `counts` to the counters of their names: what a replayed CUDA
    graph launches, its capture's tally."""
    for name, module, attr in _counters():
        if name in counts:
            setattr(module, attr, getattr(module, attr) + counts[name])


def _open(name: str, stream: bool) -> Optional[_Record]:
    global _dropped
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent = stack[-1] if stack else None
    rec = _Record()
    rec.name, rec.thread, rec.end_ns, rec.events, rec.counters = name, threading.get_ident(), None, None, None
    with _lock:
        if len(_records) >= CAP:
            _dropped += 1
            stack.append(None)
            return None
        rec.id = len(_records)
        _records.append(rec)
        rec.parent, rec.unit = (None, rec.id) if parent is None else (parent.id, parent.unit)
    stack.append(rec)
    if rec.unit == rec.id:
        rec.counters = (counters(), None)
    if stream and torch.cuda.is_initialized():
        rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec.events[0].record()
    rec.start_ns = time.perf_counter_ns()
    return rec


def _close(rec: Optional[_Record]) -> None:
    _local.stack.pop()
    if rec is None:
        return
    if rec.events is not None:
        rec.events[1].record()
    if rec.counters is not None:
        rec.counters = (rec.counters[0], counters())
    rec.end_ns = time.perf_counter_ns()  # last: `summary()` takes records that have it


class _Span:
    """A span while the profiler records: a profiler range and a record."""

    __slots__ = ("name", "stream", "_range", "_rec")

    def __init__(self, name: str, stream: bool):
        self.name = name
        self.stream = stream

    def __enter__(self) -> "_Span":
        # A function-scope range: a user-scope one (`torch.profiler.record_function`)
        # also puts a range on the card's timeline, which the trace would count as
        # device time.
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._rec = _open(self.name, self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        _close(self._rec)
        self._range.__exit__(None, None, None)
        return False


class _Off:
    """What `span` returns while the profiler is off: entering and leaving it
    runs no Python code ("" is false, so an exception goes on)."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_OFF = _Off()


def span(name: str, stream: bool = False):
    """``with span(name, stream=False):`` one range of a layer (see the
    module's docstring); while the profiler is off, one call of its flag."""
    return _Span(name, stream) if _profiling() else _OFF


def reset() -> None:
    """Forget every record and the count of those dropped; call it with no
    span open."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def summary() -> Dict:
    """What the closed records hold: ``spans``, per name its ``count``,
    ``host_ms``, ``self_host_ms`` (less the part its child spans cover) and
    ``stream_ms`` (the events' elapsed time, idle stream included; None for
    a name with none);
    ``counters``, each counter's growth inside the units; ``units``, the
    units closed; ``dropped``, the records over `CAP`."""
    with _lock:
        records = [r for r in _records if r.end_ns is not None]
        dropped = _dropped
    if any(r.events is not None for r in records):
        torch.cuda.synchronize()
    children_ns: Dict[int, int] = {}  # a parent's children follow one another on its thread
    for r in records:
        if r.parent is not None:
            children_ns[r.parent] = children_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    spans: Dict[str, Dict] = {}
    grown: Dict[str, int] = {}
    units = 0
    for r in records:
        s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0, "stream_ms": None})
        host_ns = r.end_ns - r.start_ns
        s["count"] += 1
        s["host_ms"] += host_ns / 1e6
        s["self_host_ms"] += (host_ns - children_ns.get(r.id, 0)) / 1e6
        if r.events is not None:
            s["stream_ms"] = (s["stream_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
        if r.counters is not None:
            units += 1
            before, after = r.counters
            for name, value in after.items():
                grown[name] = grown.get(name, 0) + value - before[name]
    return {"spans": spans, "counters": grown, "units": units, "dropped": dropped}
