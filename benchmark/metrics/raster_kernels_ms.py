"""Device ms a recorded step of the rasterizer's hand kernels K1-K4,
matched by their symbols in ``csrc/``."""

from benchmark.metrics._common import per_step_ms


def read(ctx):
    return per_step_ms(ctx, ["K1 blend forward", "K2 blend backward", "K3 segmented sum",
                             "K4 expand"])
