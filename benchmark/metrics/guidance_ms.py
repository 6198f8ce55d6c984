"""Device ms a recorded step put down to the program's ``system/guidance``
spans (UNet, VAE encode, the SDS arithmetic) and the backward ops the
profiler links to forward ops under them (the VAE encoder's backward
included; ``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "device_s", ["system/guidance"])
