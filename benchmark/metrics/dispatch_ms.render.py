"""Host ms a frame inside the render of one camera (`render.frame`): its
rays, every chunk's model call and the frame's assembly, enqueued; and the
waits wherever the frame waits for the card. It is the profiled host's time,
slower than the untraced one, and moves with the host's speed.

Read from the program's spans (`signerf_tpu_torch/utils/tracing.py`),
which record while the profiler does; None for a program without them."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.summary()["spans"].get("render.frame")
    if ctx.trace is None or not ctx.trace.units or found is None:
        return None
    return found["host_ms"] / ctx.trace.units
