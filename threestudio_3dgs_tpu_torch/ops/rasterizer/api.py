"""Public rasterization API (port of the JAX package's
``ops/rasterizer/api.py``: ``RasterizeConfig``, ``rasterize`` and
``_raster_core``).

Pipeline: project (torch autograd) -> bin (index math, no gradient) ->
gather per-pair features (``pair_gather``; its backward is the sort plus
segmented-sum reduction) -> blend (``torch.autograd.Function`` over the
K1/K2 kernels) -> assemble channels and composite the background.  One
blend pass carries rgb, the view depth (unless ``with_depth=False``) and
any extra per-Gaussian features, C = 3 + depth + E channels, plus the
implicit weight-sum channel (the alpha map): C = 4 on the Gaussian
renderers, 7 on SuGaR's (+ face normals).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..camera import Camera
from . import blend as blend_ops
from .binning import bin_gaussians, pair_gather
from .preprocess import project_gaussians, sh_colors


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 32
    max_pairs: int = 2**21  # ceiling; pair buffers are sized per frame below it


class Blend(torch.autograd.Function):
    """The hand-differentiated boundary: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels):
        out = blend_ops.blend_forward(
            pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels
        )
        ctx.save_for_backward(pair_feats, tile_ranges, out)
        ctx.dims = (grid_x, grid_y, tile_size, n_channels)
        return out

    @staticmethod
    def backward(ctx, g_out):
        pair_feats, tile_ranges, out = ctx.saved_tensors
        d_feats = blend_ops.blend_backward(
            pair_feats, tile_ranges, out, g_out.contiguous(), *ctx.dims
        )
        return d_feats, None, None, None, None, None


def _raster_core(proj, opacities, channels, grid_x, grid_y, tile_size, max_pairs,
                 height, width):
    """Everything after projection: bin -> per-pair features -> blend ->
    image assembly, for one view."""
    n_channels = channels.shape[1]
    binning = bin_gaussians(proj, grid_x, grid_y, max_pairs, tile_size, opacities)
    feats = torch.cat(
        [proj.means2d, proj.conics, opacities[:, None], channels], dim=1
    )  # (N, 6 + C)
    pair_feats = pair_gather(feats, binning)
    out_tiled = Blend.apply(
        pair_feats, binning.tile_ranges, grid_x, grid_y, tile_size, n_channels
    )  # (T, npix, C + 1)
    img_full = blend_ops.tiles_to_image(out_tiled, grid_x, grid_y, tile_size, height, width)
    return img_full, binning


def rasterize(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) activated
    quats: torch.Tensor,  # (N, 4)
    opacities: torch.Tensor,  # (N,) activated
    camera: Camera,
    bg_color: torch.Tensor,  # (3,)
    colors: Optional[torch.Tensor] = None,  # (N, 3) precomputed colours
    sh_coeffs: Optional[torch.Tensor] = None,  # (N, K, 3)
    sh_degree: int = 0,
    extra_features: Optional[torch.Tensor] = None,  # (N, E) blended linearly
    alive: Optional[torch.Tensor] = None,  # (N,) bool capacity mask
    means2d_offset: Optional[torch.Tensor] = None,  # (N, 2) gradient side channel
    scaling_modifier: float = 1.0,
    with_depth: bool = True,
    config: RasterizeConfig = RasterizeConfig(),
) -> Dict[str, Any]:
    """Render one view.  Returns a dict with:
      image (H, W, 3)  rgb composited over bg_color
      alpha (H, W)     1 - final transmittance
      depth (H, W)     alpha-weighted view depth (no background), if with_depth
      extra (H, W, E)  blended extra features, if given
      radii (N,), visibility (N,), n_pairs, n_dropped (host ints)"""
    height, width = camera.height, camera.width
    ts = config.tile_size
    grid_x = (width + ts - 1) // ts
    grid_y = (height + ts - 1) // ts

    proj = project_gaussians(
        means3d, scales, quats, camera, tile_size=ts,
        scaling_modifier=scaling_modifier, alive=alive, means2d_offset=means2d_offset,
    )
    if colors is None:
        if sh_coeffs is None:
            raise ValueError("provide colors or sh_coeffs")
        colors = sh_colors(means3d, sh_coeffs, camera.campos, sh_degree)
    chans = [colors]
    if with_depth:
        chans.append(proj.depths[:, None])
    if extra_features is not None:
        chans.append(extra_features)
    channels = torch.cat(chans, dim=1)  # (N, C)
    n_channels = channels.shape[1]

    img_full, binning = _raster_core(
        proj, opacities, channels, grid_x, grid_y, ts, config.max_pairs, height, width
    )
    rgb = img_full[..., :3]
    alpha = img_full[..., n_channels]
    rgb = rgb + (1.0 - alpha[..., None]) * bg_color

    result: Dict[str, Any] = {
        "image": rgb,
        "alpha": alpha,
        "radii": proj.radii,
        "visibility": proj.visible & (proj.radii > 0),
        "n_pairs": binning.n_pairs,
        "n_dropped": binning.n_dropped,
    }
    idx = 3
    if with_depth:
        result["depth"] = img_full[..., idx]
        idx += 1
    if extra_features is not None:
        result["extra"] = img_full[..., idx: idx + extra_features.shape[1]]
    return result
