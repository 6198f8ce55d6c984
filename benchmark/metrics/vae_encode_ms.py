"""Device ms a recorded step put down to the program's ``guidance/encode``
spans: the VAE encoder on the renders (``diffusion/vae.py``) and its
backward to them, which the profiler links to it (``spans.py``)."""

from benchmark.metrics._opened import device_ms


def read(ctx):
    return device_ms(ctx, "guidance/encode")
