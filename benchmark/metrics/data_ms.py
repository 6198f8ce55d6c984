"""Host ms of the data module's ``train_batch`` (the camera sampler), the
mean over the window's steps."""


def read(ctx):
    ms = ctx.get("data_ms") or []
    return sum(ms) / len(ms) if ms else None
