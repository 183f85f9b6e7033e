"""The device wall ms a train step of 3dgs:backward with the profiler off
(the measured package's recorder): autograd launches the backward's
kernels on a thread of its own, outside the range on the host, so the
profiled sub-window gives the stage nothing."""

from harness.recorded import wall_ms


def read(ctx):
    return wall_ms(ctx, "backward")
