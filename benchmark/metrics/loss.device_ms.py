"""Device ms a train step of the kernels launched under 3dgs:loss
(core/loss.py, forward)."""


def read(ctx):
    return ctx.device_ms("loss")
