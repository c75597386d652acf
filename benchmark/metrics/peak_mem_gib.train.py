"""The process' peak of allocated device memory (the allocator's
`max_memory_allocated`), in GiB."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
