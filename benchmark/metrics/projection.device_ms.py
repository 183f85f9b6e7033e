"""Device ms a step or frame of the kernels launched under 3dgs:projection
(ops/projection.py, forward)."""


def read(ctx):
    return ctx.device_ms("projection")
