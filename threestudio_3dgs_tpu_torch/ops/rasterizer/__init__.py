"""Tile rasterizer: projection, binning, the CUDA kernels and their plain
torch twins (port of the JAX package's ``ops/rasterizer``)."""

from .api import RasterizeConfig, rasterize, rasterize_batched  # noqa: F401
