"""Gaussian fields (static and spacetime), the deformation network, the
optimiser, cross-package state conversion, PLY I/O and the mesh exporter."""

from . import gaussian_field  # noqa: F401
from . import spacetime, gaussian_dynamic  # noqa: F401
from . import exporter  # noqa: F401
