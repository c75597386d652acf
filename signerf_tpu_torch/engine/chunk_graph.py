"""One eval-render chunk's forward on the card as a CUDA graph, captured
once and replayed for every chunk.

`engine.train_step.make_eval_render` renders a frame as chunks of one size,
each through the same model call: on the card a chain of several hundred
small kernels (K1's three calls among them), which the host takes longer to
launch than the card takes to run (PERF.md section 5). `chunk_forward`
gives the render its per-chunk call. On a CUDA device it copies each chunk
into the graph's static inputs and replays the graph; on any other device it
calls the model.

The graphs are kept per model, as long as the model lives, under a key of
everything that changes what was captured: the device, the chunk size, the
appearance mode, which bundle fields are set and their dtypes and widths,
the float32 matmul precision, and the address, dtype and shape of every
parameter and buffer. A new key captures anew (after `model.to(...)`, a
replaced tensor, another chunk size); a capture drops the model's graphs
whose weights have moved, and their memory pools with them. In-place
updates of the weights (Adam's `_foreach_*_`, `load_state_dict`) keep the
addresses, and the replays read the new values there.

Under a new key the first chunk runs the model eagerly on a side stream
(the warm-up, which also loads the kernels and sets their attributes), and
its outputs are that chunk's; the forward is then captured on the same
stream, with `capture_error_mode="thread_local"` (the viewer renders from
HTTP threads while the trainer's thread launches work), and every later
chunk replays it. A capture that fails raises: nothing falls back to the
eager call.

Counters (`utils/tracing.counters()`, as `render.<name>`): `chunks`,
`graph_replays`, `graph_captures`. The capture launches nothing, so what its
thread counts inside it (the kernels' launches, `factor_grid.table_pack_bytes`)
goes to the graph's own tally (`tracing.capturing`), and each replay, which
launches those kernels and packs those tables on the card, adds the tally.
`chip_smoke.py` holds the tally against the kernels a profiled replay runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import weakref
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

from signerf_tpu_torch.cameras.cameras import RayBundle
from signerf_tpu_torch.utils import tracing

# In this process; `utils/tracing` reads them.
chunks = 0  # chunks rendered through `chunk_forward`'s calls, on any device
graph_replays = 0
graph_captures = 0
COUNTERS = ("chunks", "graph_replays", "graph_captures")

Outputs = Dict[str, torch.Tensor]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: RayBundle  # the static inputs the graph reads
    outputs: Outputs  # the static outputs it writes
    counts: Dict[str, int]  # what one replay adds to the counters: the capture's tally


class _ModelGraphs:
    """A model's graphs by key, the lock that makes a frame's use of them
    one at a time, and the event its last frame recorded on its stream."""

    def __init__(self):
        self.lock = threading.Lock()
        self.by_key: Dict[tuple, _Graph] = {}
        self.done: Optional[torch.cuda.Event] = None


_models: "weakref.WeakKeyDictionary[torch.nn.Module, _ModelGraphs]" = weakref.WeakKeyDictionary()
_models_lock = threading.Lock()


def _fields(bundle: RayBundle):
    return [getattr(bundle, f.name) for f in dataclasses.fields(bundle)]


def _key(model: torch.nn.Module, bundle: RayBundle, chunk_size: int, appearance_mode: Optional[str]):
    """(what the graph's shapes and arithmetic depend on, where it reads
    the weights)."""
    fields = tuple(None if t is None else (t.dtype, tuple(t.shape[1:])) for t in _fields(bundle))
    shapes = (bundle.origins.device, chunk_size, appearance_mode, fields,
              torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    weights = tuple((t.data_ptr(), t.dtype, tuple(t.shape)) for t in itertools.chain(model.parameters(),
                                                                                      model.buffers()))
    return shapes, weights


def _capture(model: torch.nn.Module, chunk: RayBundle, appearance_mode: Optional[str], keys: Sequence[str]):
    """Warm up on `chunk` and capture the forward -> (the graph, the
    warm-up's outputs: the chunk's own)."""
    global graph_captures
    device = chunk.origins.device
    current = torch.cuda.current_stream(device)
    inputs = chunk.map(lambda x: x.clone(memory_format=torch.contiguous_format))
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = model(inputs, appearance_mode=appearance_mode)
        warm = {k: out[k] for k in keys}
    current.wait_stream(side)
    for v in warm.values():
        v.record_stream(current)
    del out
    graph = torch.cuda.CUDAGraph()
    with tracing.capturing() as counts, torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = model(inputs, appearance_mode=appearance_mode)
        outputs = {k: out[k] for k in keys}
    graph_captures += 1
    return _Graph(graph, inputs, outputs, counts), warm


@contextlib.contextmanager
def chunk_forward(
    model: torch.nn.Module, bundle: RayBundle, chunk_size: int, appearance_mode: Optional[str],
    keys: Sequence[str],
) -> Iterator[Callable[[RayBundle], Outputs]]:
    """``with chunk_forward(...) as forward:`` ``forward(chunk)`` is the
    model's outputs `keys` for one chunk of `chunk_size` rays cut from
    `bundle`, valid until the next call. On a CUDA device, a replay of the
    chunk's graph; the block holds the model's graphs for itself."""
    if bundle.origins.device.type != "cuda":

        def eager(chunk: RayBundle) -> Outputs:
            global chunks
            chunks += 1
            out = model(chunk, appearance_mode=appearance_mode)
            return {k: out[k] for k in keys}

        yield eager
        return

    with _models_lock:
        graphs = _models.setdefault(model, _ModelGraphs())
    shapes, weights = _key(model, bundle, chunk_size, appearance_mode)
    with graphs.lock:
        current = torch.cuda.current_stream(bundle.origins.device)
        if graphs.done is not None:
            current.wait_event(graphs.done)  # the last frame's copies out, on its stream
        entry = graphs.by_key.get((shapes, weights))

        def replay(chunk: RayBundle) -> Outputs:
            global chunks, graph_replays
            nonlocal entry
            chunks += 1
            if entry is None:
                entry, warm = _capture(model, chunk, appearance_mode, keys)
                graphs.by_key = {k: g for k, g in graphs.by_key.items() if k[1] == weights}
                graphs.by_key[(shapes, weights)] = entry
                return warm
            for dst, src in zip(_fields(entry.inputs), _fields(chunk)):
                if dst is not None:
                    dst.copy_(src)
            entry.graph.replay()
            tracing.add(entry.counts)
            graph_replays += 1
            return entry.outputs

        try:
            yield replay
        finally:
            graphs.done = torch.cuda.Event()
            graphs.done.record(current)
