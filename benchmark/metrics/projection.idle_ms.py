"""The card's idle ms a step or frame inside 3dgs:projection: the stage's
device wall with the profiler off (the measured package's recorder) less
the device ms of its kernels in the profiled sub-window."""

from harness.recorded import idle_ms


def read(ctx):
    return idle_ms(ctx, "projection")
