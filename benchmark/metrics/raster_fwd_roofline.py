"""The forward raster kernel (B1, csrc/raster_fwd.cu) in the traced steps or
frames: the least time its pairs and bytes allow over its device time, in %."""


def read(ctx):
    return ctx.roofline_pct("raster_fwd")
