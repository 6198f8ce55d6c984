"""K5's share of its roofline in the recorded steps: the sum over its
launches of each shape's bound (``costs.k5_bound_s``) over its device
time.  The shapes come from the program's launch counter by shape; the
type is the configuration's (bf16 or f32 attention)."""

from benchmark import costs


def read(ctx):
    tr = ctx.get("trace")
    launches = ctx.get("k5_launches") or {}
    k5_s = (tr or {}).get("families", {}).get("K5 flash attention", 0.0)
    if not tr or k5_s <= 0 or not any(launches.values()):
        return None
    dtype = "bf16" if ctx["cell"]["config"]["dtype"] == "bfloat16" else "f32"
    sm_hz = (ctx.get("card") or {}).get("sm_hz") or costs.SM_MAX_HZ
    bound = 0.0
    for tag, n in launches.items():
        bh, tokens, d = (int(x) for x in tag.split("x"))
        bound += n * costs.k5_bound_s(bh, tokens, d, dtype, sm_hz)[0]
    return 100.0 * bound / k5_s
