from . import gaussian_material, no_material  # noqa: F401
