"""Device ms a recorded step under the program's ``render/project`` spans:
each render's projection (kernel K7's forward) and, inside
``render/backward``, its hand backward (``ops/rasterizer/project.py``)."""

from benchmark.metrics._opened import device_ms


def read(ctx):
    return device_ms(ctx, "render/project")
