"""Device ms a recorded step put down to the program's ``guidance/unet``
spans: the guidance's UNet call on its CFG batch (``diffusion/unet.py``;
no backward, the SDS target carries no gradient)."""

from benchmark.metrics._opened import device_ms


def read(ctx):
    return device_ms(ctx, "guidance/unet")
