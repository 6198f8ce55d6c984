"""Multi-device training and rendering on ``torch.distributed`` (port of the
JAX package's ``parallel/``): one process per rank, as ``torchrun`` starts
them; collectives on explicit process groups."""

from . import data_parallel, hybrid, mesh, tile_parallel  # noqa: F401
