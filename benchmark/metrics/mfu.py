"""A step's or frame's float32 operations (the benchmark's own counts) over
the unprofiled time a step, as a share of the card's float32 peak, in %."""


def read(ctx):
    return ctx.mfu_pct()
