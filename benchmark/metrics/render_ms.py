"""Device ms a recorded step put down to the program's ``system/render``
spans (the renders' forward, with the binning's pair-total read) and
``render/*`` spans (the rasterizer's hand backward), and the backward
ops the profiler links to forward ops under them (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "device_s", ["system/render", "render/backward",
                                              "render/host_read"])
