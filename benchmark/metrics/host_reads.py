"""The program's ``*/host_read`` spans a recorded step: each one value
read to the host (``fit``'s logged values, the binning's pair total, the
live-row count; ``utils/tracing.py``)."""

from benchmark import spans


def read(ctx):
    s = spans.from_ctx(ctx)
    if not s:
        return None
    n = sum(c for path, c in s["count"].items() if path.endswith("/host_read"))
    return n / s["steps"]
