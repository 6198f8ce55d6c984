"""Gaussian fields (static, spacetime and mesh-bound SuGaR), the
deformation network, the optimiser, cross-package state conversion, PLY
I/O and the mesh exporter."""

from . import gaussian_field  # noqa: F401
from . import spacetime, gaussian_dynamic  # noqa: F401
from . import exporter, sugar  # noqa: F401
