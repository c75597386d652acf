"""Stream ms a step between the CUDA events around autograd's backward of
the step's micro-batches (`engine.backward`): the layer's kernels and the
time the stream waits for the host between them. Not the layer's device
time: the traced step is paced by the profiled host, so the interval follows
the host's speed.

Read from the program's spans (`signerf_tpu_torch/utils/tracing.py`),
which record while the profiler does; None for a program without them, and
on the CPU, where no events are recorded."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.summary()["spans"].get("engine.backward")
    if ctx.trace is None or not ctx.trace.units or found is None or found["stream_ms"] is None:
        return None
    return found["stream_ms"] / ctx.trace.units
