"""Instances a step or frame: the stream length binning emits
(`Binning.n_live`, counted by the measured package at 3dgs:binning)."""

from harness.recorded import program


def read(ctx):
    p = program(ctx)
    return None if p is None else p["counters"].get("instances")
