"""The factor-grid work's share of its roofline: the least time its calls
could take at the card's published peaks (bytes at 3.35 TB/s against
operations at 989 TFLOP/s bf16 and 67 TFLOP/s f32, counted from the calls'
shapes, not from which kernel runs them) over the device time of the
kernels that do it (K1 to K6), a unit of work at a time."""

from harness import peaks


def read(ctx):
    if ctx.trace is None:
        return None
    device_ms = sum(ctx.trace.per_unit_ms(g) for g in peaks.FACTOR_KERNELS)
    if not device_ms > 0:
        return None
    return 100.0 * ctx.extra["factor_bound_ms_per_unit"] / device_ms
