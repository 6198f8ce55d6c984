"""% of the recorded steps' wall time in which no kernel, copy or set ran
on the device."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
