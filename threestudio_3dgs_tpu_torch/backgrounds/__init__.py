from . import neural_env, solid  # noqa: F401
