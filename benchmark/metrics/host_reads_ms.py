"""Device ms a recorded step of device-to-host copies: ``fit``'s
per-value reads of the logged losses (and the step's other host reads)."""

from benchmark.metrics._common import per_step_ms


def read(ctx):
    return per_step_ms(ctx, ["copy DtoH"])
