from . import gaussian, spacetime  # noqa: F401
