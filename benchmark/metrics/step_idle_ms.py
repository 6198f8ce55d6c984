"""ms a recorded step in which the device ran nothing while the main
thread was inside the program's ``fit/train_step`` span (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "idle_s", ["fit/train_step"])
