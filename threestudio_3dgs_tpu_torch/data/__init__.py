from . import image, temporal_image, uncond  # noqa: F401
