"""Device ms a step of the kernels launched under 3dgs:adam
(train/optimizer.py)."""


def read(ctx):
    return ctx.device_ms("adam")
