"""The program's ``render/timed`` spans a recorded step: the spacetime
field's timed evaluations, one a rendered view (and one for a batch's
spline knots)."""

from benchmark.metrics._opened import count


def read(ctx):
    n = count(ctx, "render/timed")
    return n / ctx["spans"]["steps"] if n else None
