"""Device ms a step or frame of the kernels launched under 3dgs:binning and
3dgs:pack (ops/binning.py)."""


def read(ctx):
    return ctx.device_ms("binning", "pack")
