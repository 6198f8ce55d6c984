from . import gaussian_mvdream, gaussian_splatting, gaussian_zero123  # noqa: F401
from . import gaussian_4dgen, sugar_static, sugar_4dgen  # noqa: F401
