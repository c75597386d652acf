"""The share of the traced window in which no operation ran on the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s > 0:
        return None
    return 100.0 * ctx.trace.idle_share
