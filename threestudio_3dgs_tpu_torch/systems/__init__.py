from . import gaussian_mvdream, gaussian_splatting  # noqa: F401
