from . import gaussian, spacetime, sugar  # noqa: F401
