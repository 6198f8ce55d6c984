"""Gaussian fields (static, spacetime, and mesh-bound SuGaR, static and
dynamic), the deformation network, the optimiser, cross-package state
conversion, PLY I/O, the mesh exporter and the host-side mesh tools (the
decimator, heat-method geodesics)."""

from . import gaussian_field  # noqa: F401
from . import spacetime, gaussian_dynamic  # noqa: F401
from . import exporter, sugar, dynamic_sugar  # noqa: F401
