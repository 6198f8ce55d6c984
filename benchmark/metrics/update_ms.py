"""Device ms a recorded step put down to the program's ``system/update``
(Adam on the field and the background) and ``system/densify`` spans (the
densify statistics, the pair-capacity controller, the structural update;
``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "device_s", ["system/update", "system/densify"])
