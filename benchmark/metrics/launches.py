"""Launches a step or frame: CUDA kernels, copies and fills on the card's
timeline, over the traced steps."""


def read(ctx):
    return ctx.launches()
