"""Device ms a recorded step of the library sorts (the binning's depth
and tile sorts; nothing else in the step sorts)."""

from benchmark.metrics._common import per_step_ms


def read(ctx):
    return per_step_ms(ctx, ["sort (library)"])
