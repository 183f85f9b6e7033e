"""The backward raster kernel (B2, csrc/raster_bwd.cu) in the traced steps:
the least time its pairs and bytes allow over its device time, in %."""


def read(ctx):
    return ctx.roofline_pct("raster_bwd")
