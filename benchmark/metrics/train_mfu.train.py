"""The step's share of the card's peak: the time its counted FLOPs would
take at the published peaks (tensor-core bf16 at 989 TFLOP/s, f32 at 67
TFLOP/s; `harness/flops.py`) over the step's wall time in the untraced part
of the window."""


def read(ctx):
    if not ctx.unit_wall_s > 0:
        return None
    return 100.0 * ctx.extra["peak_s_per_unit"] / ctx.unit_wall_s
