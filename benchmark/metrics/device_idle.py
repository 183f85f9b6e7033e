"""The card's idle share of a step or frame, in %: 1 - the traced steps'
busy seconds a step over the window's unprofiled seconds a step (the
profiler slows the host, so its own wall time would count its cost as
idle)."""


def read(ctx):
    return ctx.idle_pct()
