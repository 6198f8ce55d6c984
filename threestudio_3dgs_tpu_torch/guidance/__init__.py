from . import base, fake, stable_diffusion  # noqa: F401
