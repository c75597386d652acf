"""Host ms a frame inside K1's autograd wrapper (`ops.k1`,
`_FusedDensityMLP.forward`): its checks, the tables packed, the weights cast
and the launch, for every field of every chunk. It is the profiled host's
time, slower than the untraced one, and moves with the host's speed.

Read from the program's spans (`signerf_tpu_torch/utils/tracing.py`),
which record while the profiler does; None for a program without them."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.summary()["spans"].get("ops.k1")
    if ctx.trace is None or not ctx.trace.units or found is None:
        return None
    return found["host_ms"] / ctx.trace.units
