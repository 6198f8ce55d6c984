"""% of the card's peak in the step's model FLOPs: the least time the
peaks allow for them, as the configuration's kind counts them
(``model_seconds`` of ``kinds/<kind>.py``), over the traced run's step
time after its recorded steps."""

from benchmark import kinds


def read(ctx):
    step_s = ctx.get("step_s_untraced")
    if not step_s:
        return None
    t = kinds.load(ctx["cell"]).model_seconds(ctx["cell"]["config"], ctx, ctx["flags"])
    return 100.0 * t / step_s
