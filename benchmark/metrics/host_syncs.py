"""Host syncs a step or frame: the "synchronizing CUDA operation" warnings
the measured package's recorder counts in its pass with
`count_syncs=True`, summed over its stages and outside them (none without
a card)."""

from harness.recorded import program


def read(ctx):
    p = program(ctx)
    return None if p is None else p["counters"].get("host_syncs")
