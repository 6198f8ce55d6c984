from . import gaussian_mvdream, gaussian_splatting, gaussian_zero123  # noqa: F401
