"""Device ms a recorded step of the library families only the diffusion
models launch: convolutions and matmuls, norms, cuDNN's layout
transposes and softmax (not their elementwise work, which shares its
family with the render's and the optimizer's)."""

from benchmark.metrics._common import per_step_ms


def read(ctx):
    return per_step_ms(ctx, ["conv / matmul (library)", "norm (library)",
                             "layout transpose (library)", "softmax (library)"])
