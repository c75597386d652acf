"""MB a frame of line tables packed for the kernels (`pack_tables`, each
field's tables cast to one bf16 buffer at every kernel call): the growth of
the program's `factor_grid.table_pack_bytes` inside the traced frames.

Read from the program's counters (`signerf_tpu_torch/utils/tracing.py`);
None for a program without them."""


def read(ctx):
    try:
        from signerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    grown = tracing.summary()["counters"].get("factor_grid.table_pack_bytes")
    if ctx.trace is None or not ctx.trace.units or grown is None:
        return None
    return grown / 1e6 / ctx.trace.units
