from . import image, uncond  # noqa: F401
