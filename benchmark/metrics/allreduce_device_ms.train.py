"""Rank 0's device ms a step in NCCL's kernels: the gradient all-reduce of
the data mesh, with the time the kernel waits for the other ranks in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s > 0:
        return None
    ms = ctx.trace.per_unit_ms("nccl")
    return ms if ms > 0 else None
