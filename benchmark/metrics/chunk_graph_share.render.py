"""Share, in %, of a traced frame's chunks that replayed a CUDA graph
(`engine/chunk_graph.py`): the growth of the program's
`render.graph_replays` over that of `render.chunks` inside the traced
frames.

Read from the program's counters (`signerf_tpu_torch/utils/tracing.py`);
None for a program without them."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    grown = tracing.summary()["counters"]
    if ctx.trace is None or not grown.get("render.chunks"):
        return None
    return 100.0 * grown.get("render.graph_replays", 0) / grown["render.chunks"]
