"""Device ms a recorded step put down to the program's
``system/motion_reg`` spans: the 4D system's anchor, lite ARAP and
inter-frame losses (``systems/gaussian_4dgen.py``), with their linked
backward ops."""

from benchmark.metrics._opened import device_ms


def read(ctx):
    return device_ms(ctx, "system/motion_reg")
