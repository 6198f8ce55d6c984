"""Public rasterization API (port of the JAX package's
``ops/rasterizer/api.py``: ``RasterizeConfig``, ``rasterize``,
``rasterize_batched`` and ``_raster_core``).

Pipeline: project (``Project``: kernel K7 and its hand backward; the row
fields the binning reads come with it) -> bin (index math, no gradient) ->
gather per-pair features (``pair_gather``; its backward is the sort plus
segmented-sum reduction) -> blend (``torch.autograd.Function`` over the
K1/K2 kernels) -> assemble channels and composite the background.  One
blend pass carries rgb, the view depth (unless ``with_depth=False``) and
any extra per-Gaussian features, C = 3 + depth + E channels, plus the
implicit weight-sum channel (the alpha map): C = 4 on the Gaussian
renderers, 7 on SuGaR's (+ face normals).

``rasterize_batched`` is the one body of that pipeline, for B >= 1 views
of one scene.  B > 1 views are stacked as tile rows of one
(B * grid_y, grid_x) grid, so one depth sort, one expand (K4), one tile
sort, one blend (K1, K2) and one segmented sum (K3, over B * N segments)
serve the batch, the kernels told the views' height in tiles
(``view_grid_y``) so that pixel rows and culling stay view-local.  One
view is an ordinary grid (``view_grid_y`` 0).  Outputs equal one view's
render (the same pairs in the same order per tile) up to the one pair
capacity the views share.  ``rasterize`` is its call with one camera, the
view axis dropped.

``rasterize(..., tile_band=(row0, rows))`` renders one horizontal band of
tile rows of a view (``band_projection``): the body of each rank of the
tile-sharded renderers in ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ...utils.tracing import span
from ..camera import Camera
from . import blend as blend_ops
from .binning import bin_gaussians, pair_gather
from .preprocess import Projected, sh_colors
from .project import project


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 32
    max_pairs: int = 2**21  # ceiling; pair buffers are sized per frame below it


class Blend(torch.autograd.Function):
    """The hand-differentiated boundary: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels,
                view_grid_y=0):
        out = blend_ops.blend_forward(
            pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels, view_grid_y
        )
        ctx.save_for_backward(pair_feats, tile_ranges, out)
        ctx.dims = (grid_x, grid_y, tile_size, n_channels, view_grid_y)
        return out

    @staticmethod
    def backward(ctx, g_out):
        pair_feats, tile_ranges, out = ctx.saved_tensors
        with span("render/backward"):
            d_feats = blend_ops.blend_backward(
                pair_feats, tile_ranges, out, g_out.contiguous(), *ctx.dims
            )
        return d_feats, None, None, None, None, None, None


def _raster_core(proj, opacities, channels, grid_x, grid_y, tile_size, max_pairs,
                 height, width, view_grid_y=0, rows=None):
    """Everything after projection: bin -> per-pair features -> blend ->
    image assembly, over a flat scene of M Gaussians on a (grid_y, grid_x)
    tile grid: one view, or (``view_grid_y`` > 0) B views' Gaussians, M =
    B * N, on the grid of the views stacked as tile rows.  ``rows``: the
    binning's row fields as K7 wrote them (None: the plain row pass)."""
    n_channels = channels.shape[1]
    binning = bin_gaussians(proj, grid_x, grid_y, max_pairs, tile_size, opacities,
                            view_grid_y, rows)
    feats = torch.cat(
        [proj.means2d, proj.conics, opacities[:, None], channels], dim=1
    )  # (M, 6 + C)
    pair_feats = pair_gather(feats, binning)
    out_tiled = Blend.apply(
        pair_feats, binning.tile_ranges, grid_x, grid_y, tile_size, n_channels, view_grid_y
    )  # (T, npix, C + 1)
    img_full = blend_ops.tiles_to_image(out_tiled, grid_x, grid_y, tile_size, height, width)
    return img_full, binning


def band_projection(proj: Projected, row0: int, rows: int, tile_size: int) -> Projected:
    """A full-camera projection restricted to the band of tile rows
    [row0, row0 + rows): tile rects clipped to the band and re-based to its
    first row, pixel y shifted by row0 * tile_size, and a Gaussian whose
    clipped rect is empty in y made invisible.  Means, conics, depths and
    radii stay the full view's, so their gradients are too."""
    tmin_y = torch.clamp(proj.tiles_min[:, 1], row0, row0 + rows) - row0
    tmax_y = torch.clamp(proj.tiles_max[:, 1], row0, row0 + rows) - row0
    shift = torch.tensor([0.0, float(row0 * tile_size)], dtype=proj.means2d.dtype,
                         device=proj.means2d.device)
    return proj._replace(
        means2d=proj.means2d - shift,
        tiles_min=torch.stack([proj.tiles_min[:, 0], tmin_y], dim=1),
        tiles_max=torch.stack([proj.tiles_max[:, 0], tmax_y], dim=1),
        visible=proj.visible & (tmax_y > tmin_y),
    )


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
    tile_band: Optional[Tuple[int, int]] = None,  # (first tile row, tile rows)
) -> Dict[str, Any]:
    """Render one view: ``rasterize_batched`` of one camera, the view axis
    dropped.  Returns a dict with:
      image (H, W, 3)  rgb composited over bg_color
      alpha (H, W)     1 - final transmittance
      depth (H, W)     alpha-weighted view depth (no background), if with_depth
      extra (H, W, E)  blended extra features, if given
      radii (N,), visibility (N,), n_pairs, n_dropped (host ints)

    With ``tile_band = (row0, rows)`` only the band of tile rows
    [row0, row0 + rows) is rendered, H becoming rows * tile_size: the
    projection runs against the full camera and ``band_projection`` clips
    it, so K1/K2/K4 see an ordinary (rows, grid_x) view.  The band's pixels
    equal the full render's up to the reassociated f32 pixel offsets
    (the JAX package measured 2.3e-6); radii equal, and visibility is the
    band's."""
    out = rasterize_batched(
        means3d, scales, quats, opacities, [camera], bg_color, colors=colors,
        sh_coeffs=sh_coeffs, sh_degree=sh_degree, extra_features=extra_features, alive=alive,
        means2d_offset=means2d_offset, scaling_modifier=scaling_modifier,
        with_depth=with_depth, config=config, tile_band=tile_band,
    )
    return {k: v if k in ("n_pairs", "n_dropped") else v.squeeze(0) for k, v in out.items()}


def _per_view(arr: Optional[torch.Tensor], base_ndim: int, v: int) -> Optional[torch.Tensor]:
    """View v of an attribute that has a leading view axis (time-varying
    attributes render each view at its own time), else the attribute."""
    if arr is None:
        return None
    return arr if arr.dim() == base_ndim else arr[v]


def rasterize_batched(
    means3d: torch.Tensor,  # (N, 3) or (B, N, 3) per view
    scales: torch.Tensor,  # (N, 3) or (B, N, 3), activated
    quats: torch.Tensor,  # (N, 4) or (B, N, 4)
    opacities: torch.Tensor,  # (N,) or (B, N), activated
    cameras: Sequence[Camera],  # B cameras of one height and width
    bg_color: Optional[torch.Tensor],  # (3,) or (B, 3); None: zero, nothing composited
    colors: Optional[torch.Tensor] = None,  # (N, 3) or (B, N, 3)
    sh_coeffs: Optional[torch.Tensor] = None,  # (N, K, 3) or (B, N, K, 3)
    sh_degree: int = 0,
    extra_features: Optional[torch.Tensor] = None,  # (N, E) or (B, N, E)
    alive: Optional[torch.Tensor] = None,  # (N,) or (B, N)
    means2d_offset: Optional[torch.Tensor] = None,  # (B, N, 2), or (N, 2) for one view
    scaling_modifier: float = 1.0,
    with_depth: bool = True,
    config: RasterizeConfig = RasterizeConfig(),
    tile_band: Optional[Tuple[int, int]] = None,  # one camera's (first tile row, tile rows)
) -> Dict[str, Any]:
    """Render B views of one scene in a single pass of the pipeline.

    View v is projected into its camera, its means kept view-local and,
    for B > 1, its tile rects shifted down by v * grid_y rows; the B * N
    Gaussians then go through one binning, one blend and one gradient
    reduction on the (B * grid_y, grid_x) grid, the kernels taking each
    tile's pixel rows in its view (``view_grid_y = grid_y``; 0 for one
    view, which is then an ordinary grid).  Each tile belongs to one view
    and gets that view's pairs in its own depth order, so the outputs
    equal the per-view renders'.

    ``config.max_pairs`` is the capacity all views share: past it the
    globally deepest pairs drop.  Returns ``rasterize``'s dict with a
    leading view axis: image (B, H, W, 3), alpha (B, H, W), depth, extra,
    radii (B, N), visibility (B, N); n_pairs / n_dropped are the totals
    (host ints).  ``tile_band`` (see ``rasterize``) takes one camera."""
    b = len(cameras)
    if tile_band is not None and b != 1:
        raise ValueError(f"tile_band renders a band of one camera, got {b} cameras")
    height, width = cameras[0].height, cameras[0].width
    ts = config.tile_size
    grid_x = (width + ts - 1) // ts
    grid_y = (height + ts - 1) // ts
    n = means3d.shape[-2]
    for cam in cameras:
        assert cam.height == height and cam.width == width, \
            "rasterize_batched requires equal view sizes"

    proj, rows = project(
        means3d, scales, quats, opacities, cameras, ts, scaling_modifier=scaling_modifier,
        alive=alive, means2d_offset=means2d_offset,
    )
    if tile_band is not None:  # the clipped rects take the plain row pass
        row0, grid_y = int(tile_band[0]), int(tile_band[1])
        height = grid_y * ts
        proj, rows = band_projection(proj, row0, grid_y, ts), None
    view_h = grid_y * ts  # a view's stride in the stacked image's rows
    chans_v, opac_v = [], []
    for v, cam in enumerate(cameras):
        opac_v.append(_per_view(opacities, 1, v))
        if colors is not None:
            col_v = _per_view(colors, 2, v)
        else:
            if sh_coeffs is None:
                raise ValueError("provide colors or sh_coeffs")
            col_v = sh_colors(_per_view(means3d, 2, v), _per_view(sh_coeffs, 3, v), cam.campos,
                              sh_degree)
        chans = [col_v]
        if with_depth:
            chans.append(proj.depths[v * n:(v + 1) * n, None])
        if extra_features is not None:
            chans.append(_per_view(extra_features, 2, v))
        chans_v.append(torch.cat(chans, dim=1))

    if b > 1:
        channels, opac = torch.cat(chans_v, dim=0), torch.cat(opac_v, dim=0)  # (B * N, C)
    else:  # one view's rows as they are: no copy
        (channels,), (opac,) = chans_v, opac_v
    n_channels = channels.shape[1]
    img_full, binning = _raster_core(
        proj, opac, channels, grid_x, b * grid_y, ts, config.max_pairs, b * view_h, width,
        view_grid_y=grid_y if b > 1 else 0, rows=rows,
    )  # (B * view_h, W, C + 1)
    img = img_full.reshape(b, view_h, width, n_channels + 1)[:, :height]

    rgb = img[..., :3]
    alpha = img[..., n_channels]
    if bg_color is not None:
        bg = torch.broadcast_to(bg_color.reshape(-1, 3), (b, 3))[:, None, None, :]
        rgb = rgb + (1.0 - alpha[..., None]) * bg

    result: Dict[str, Any] = {
        "image": rgb,
        "alpha": alpha,
        "radii": proj.radii.reshape(b, n),
        "visibility": (proj.visible & (proj.radii > 0)).reshape(b, n),
        "n_pairs": binning.n_pairs,
        "n_dropped": binning.n_dropped,
    }
    idx = 3
    if with_depth:
        result["depth"] = img[..., idx]
        idx += 1
    if extra_features is not None:
        result["extra"] = img[..., idx: idx + extra_features.shape[-1]]
    return result
