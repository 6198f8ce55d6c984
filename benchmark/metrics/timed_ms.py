"""Device ms a recorded step put down to the program's ``render/timed``
spans: the spacetime field evaluated at each rendered view's time over
every row of the field (``renderers/spacetime.py``), with the backward ops
the profiler links to it (``spans.py``)."""

from benchmark.metrics._opened import device_ms


def read(ctx):
    return device_ms(ctx, "render/timed")
