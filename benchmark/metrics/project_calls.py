"""The program's ``render/project`` spans a recorded step: one a render's
projection and one its backward, so a step that renders V views with
gradients reads 2 V (60 in ``gs4d.motion``'s 30 renders)."""

from benchmark.metrics._opened import count


def read(ctx):
    n = count(ctx, "render/project")
    return n / ctx["spans"]["steps"] if n else None
