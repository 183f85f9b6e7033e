"""Non-finite entries a train step of its parameters' gradients (counter
`grad_nonfinite` of the measured package's recorder, counted after
3dgs:backward); None where the package has no such counter."""

from harness.recorded import program


def read(ctx):
    p = program(ctx)
    return None if p is None else p["counters"].get("grad_nonfinite")
