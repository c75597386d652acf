"""Host ms a step inside the train step's call (`engine.step`): the time the
host takes to enqueue the step, and to wait wherever the step waits for the
card. It is the profiled host's time: the profiler's cost per operator
makes the traced step host-bound, so this reads above the untraced step
and moves with the host's speed; it does not say whether the untraced
host keeps ahead of the card.

Read from the program's spans (`signerf_tpu_torch/utils/tracing.py`),
which record while the profiler does; None for a program without them."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.summary()["spans"].get("engine.step")
    if ctx.trace is None or not ctx.trace.units or found is None:
        return None
    return found["host_ms"] / ctx.trace.units
