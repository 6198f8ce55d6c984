from . import base, fake, mvdream, stable_diffusion, temporal_zero123  # noqa: F401
