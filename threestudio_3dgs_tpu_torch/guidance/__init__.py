from . import base, fake, mvdream, stable_diffusion  # noqa: F401
