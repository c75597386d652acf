"""Device ms a unit of work (a step, a frame) in kernels other than the
port's own, cuDNN's convolutions, GEMMs and NCCL: PyTorch's eager
elementwise, reduction, indexing and copy kernels."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s > 0:
        return None
    return ctx.trace.per_unit_ms("other")
