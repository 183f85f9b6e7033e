"""The card's idle ms a step or frame inside 3dgs:binning and 3dgs:pack:
their device walls with the profiler off (the measured package's
recorder) less the device ms of their kernels in the profiled
sub-window."""

from harness.recorded import idle_ms


def read(ctx):
    return idle_ms(ctx, "binning", "pack")
