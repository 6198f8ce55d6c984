"""Tile binning: expand (Gaussian x covered tile) pairs, group them by tile
with depth order kept, compute per-tile ranges, and reduce the per-pair
gradients back to the Gaussians.

Port of the unpacked path of the JAX package's
``ops/rasterizer/binning.py``:

  1. exact reachability bitmask for rects of <= MASK_K tiles (counts become
     exact; bigger rects keep area counts and are culled per pair);
  2. one stable depth sort of the Gaussians, zero-count Gaussians at +inf;
  3. pair buffers sized from the exact total each frame (one host read),
     with ``max_pairs`` as the ceiling beyond which the deepest pairs drop;
  4. expand (kernel K4) writing (slot, Gaussian, tile, key) per pair, from
     one packed (x0, y0, w, mask) row per Gaussian;
  5. one sort of the int64 keys (tile << 32) | depth_rank and the tile
     ranges by ``searchsorted``.

With ``view_grid_y`` > 0 the Gaussians are B views' concatenated, their
tile rects shifted to the views' rows of one stacked grid and their means
view-local (``api.rasterize_batched``): the reachability tests take a
tile's row in its view, ``ty % view_grid_y``; the one global depth sort
keeps each view's Gaussians in their own order (the sort is stable), so
every tile gets its pairs in its view's order; and the one capacity drops
the globally deepest pairs, as the JAX package's does.

The int64 keys remove the 31-bit packed-key limit of the JAX package, and
the 24/21-bit payload packs and one-hot selects (TPU sort-operand
workarounds) are not ported.  The sorts are library sorts.

``pair_gather`` is the differentiable (N, F) -> (P, F) row gather whose
backward sorts the pair-gradient rows by Gaussian id and reduces them with
the segmented sum (kernel K3) over the per-Gaussian pair counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .expand import MASK_K, MASK_NONE, expand_bin, pack_rect, tile_reachable
from .preprocess import Projected
from .segsum import segsum_monotone

_KEY_SHIFT = 32


class PairPlan(NamedTuple):
    """The depth-sorted pair layout of one view: the expand kernel's inputs
    plus the pair accounting."""

    offsets: torch.Tensor  # (N,) int64 exclusive pair offsets, depth order
    kept: torch.Tensor  # (N,) int64 pairs kept per Gaussian, depth order
    depth_order: torch.Tensor  # (N,) int64 Gaussian indices sorted by depth
    # (N, 4) int32 [tile rect min x, min y, width, reachable-tile bitmask
    # or MASK_NONE], original order: one 16-byte row per Gaussian
    rect: torch.Tensor
    cull_fields: torch.Tensor  # (N, 6) f32 [mx, my, ca, cb, cc, opa]
    n_pairs: int  # pairs kept (<= max_pairs)
    n_dropped: int  # pairs dropped for capacity
    grid_x: int
    tile_size: int
    num_tiles: int
    view_grid_y: int = 0  # tile rows a view, on a grid of stacked views

    def expand(self, fn=expand_bin):
        """Run the pair expansion (``expand_bin`` or one of its versions)."""
        return fn(
            self.offsets, self.kept, self.depth_order, self.rect, self.n_pairs,
            self.grid_x, tile_size=self.tile_size, num_tiles=self.num_tiles,
            cull_fields=self.cull_fields, view_grid_y=self.view_grid_y,
        )


class Binning(NamedTuple):
    pair_gauss: torch.Tensor  # (P,) int64 original Gaussian index, tile order
    tile_ranges: torch.Tensor  # (T + 1,) int64; tile t owns [r[t], r[t+1])
    seg_counts: torch.Tensor  # (N,) int64 pairs per Gaussian, original order
    n_pairs: int  # pairs kept (<= max_pairs)
    n_dropped: int  # pairs dropped for capacity
    view_grid_y: int = 0  # tile rows a view, on a grid of stacked views


def plan_pairs(
    proj: Projected,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    tile_size: int,
    opacities: torch.Tensor,  # (N,) activated
    view_grid_y: int = 0,
) -> PairPlan:
    """Pairs whose Gaussian cannot reach alpha >= 1/255 inside the tile are
    culled: the blend would zero them anyway (same threshold)."""
    device = proj.depths.device
    n = proj.depths.shape[0]
    means2d = proj.means2d.detach()
    conics = proj.conics.detach()
    opa = opacities.detach()

    tmin = proj.tiles_min.long()
    rect_w = proj.tiles_max[:, 0].long() - tmin[:, 0]
    rect_h = proj.tiles_max[:, 1].long() - tmin[:, 1]
    counts_all = torch.where(proj.visible, rect_w * rect_h, torch.zeros_like(rect_w))

    # exact pre-expansion culling of rects with <= MASK_K tiles
    jj = torch.arange(MASK_K, device=device)[None, :]
    w_k = torch.clamp_min(rect_w, 1)[:, None]
    tx = tmin[:, 0:1] + jj % w_k
    ty = tmin[:, 1:2] + jj // w_k
    if view_grid_y:
        ty = ty % view_grid_y
    reach = tile_reachable(
        (tx * tile_size).float(), (ty * tile_size).float(), float(tile_size),
        means2d[:, 0:1], means2d[:, 1:2],
        conics[:, 0:1], conics[:, 1:2], conics[:, 2:3], opa[:, None],
    )
    reach = reach & (jj < counts_all[:, None])
    mask = torch.sum(reach.long() << jj, dim=1)
    small = proj.visible & (counts_all <= MASK_K)
    counts_all = torch.where(small, reach.sum(dim=1), counts_all)
    mask = torch.where(small, mask, torch.full_like(mask, MASK_NONE))

    # one stable depth sort; fully culled Gaussians (count 0) go last
    sort_depth = torch.where(
        counts_all > 0, proj.depths.detach(), torch.full_like(proj.depths, float("inf"))
    )
    depth_order = torch.sort(sort_depth, stable=True).indices
    counts = counts_all[depth_order]
    cs = torch.cumsum(counts, dim=0)
    offsets = cs - counts
    total = int(cs[-1]) if n else 0  # the one host read that sizes the buffers
    n_pairs = min(total, max_pairs)
    return PairPlan(
        offsets=offsets,
        kept=torch.minimum(counts, torch.clamp_min(n_pairs - offsets, 0)),
        depth_order=depth_order,
        rect=pack_rect(tmin[:, 0], tmin[:, 1], rect_w, mask),
        cull_fields=torch.cat([means2d, conics, opa[:, None]], dim=1).contiguous(),
        n_pairs=n_pairs,
        n_dropped=total - n_pairs,
        grid_x=grid_x,
        tile_size=tile_size,
        num_tiles=grid_x * grid_y,
        view_grid_y=view_grid_y,
    )


def bin_gaussians(
    proj: Projected,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    tile_size: int,
    opacities: torch.Tensor,  # (N,) activated
    view_grid_y: int = 0,
) -> Binning:
    plan = plan_pairs(proj, grid_x, grid_y, max_pairs, tile_size, opacities, view_grid_y)
    _, gauss, _, key = plan.expand()
    # stable, so the culled pairs past the last tile keep expand order
    sorted_key, order = torch.sort(key, stable=True)
    boundaries = (
        torch.arange(plan.num_tiles + 1, device=key.device, dtype=torch.int64) << _KEY_SHIFT
    )
    seg_counts = torch.zeros_like(plan.kept).scatter_(0, plan.depth_order, plan.kept)
    return Binning(
        pair_gauss=gauss[order].long(),
        tile_ranges=torch.searchsorted(sorted_key, boundaries),
        seg_counts=seg_counts,
        n_pairs=plan.n_pairs,
        n_dropped=plan.n_dropped,
        view_grid_y=view_grid_y,
    )


def segsum_inputs(binning: Binning, d_pairs: torch.Tensor):
    """The segmented sum's inputs for one backward: the (P, F) pair
    gradients sorted by Gaussian id (stable, so each Gaussian's rows keep
    tile order) with the culled rows past the last tile range zeroed, and
    each Gaussian's (offset, count) in original order.  A culled row stays
    in its Gaussian's segment; the per-frame sizing leaves no capacity
    tail to key elsewhere."""
    rows = torch.arange(d_pairs.shape[0], device=d_pairs.device)
    valid = (rows < binning.tile_ranges[-1])[:, None]
    d_safe = torch.where(valid, d_pairs, torch.zeros_like(d_pairs))
    order = torch.sort(binning.pair_gauss, stable=True).indices
    counts = binning.seg_counts
    return d_safe[order].contiguous(), (torch.cumsum(counts, dim=0) - counts), counts


class PairGather(torch.autograd.Function):
    """(N, F) per-Gaussian features -> (P, F) tile-ordered per-pair rows;
    the backward is the sort plus segmented sum (kernel K3)."""

    @staticmethod
    def forward(ctx, feats: torch.Tensor, binning: Binning):
        ctx.binning = binning
        return feats[binning.pair_gauss]

    @staticmethod
    def backward(ctx, d_pairs: torch.Tensor):
        tag = "stacked" if ctx.binning.view_grid_y else ""
        return segsum_monotone(*segsum_inputs(ctx.binning, d_pairs.contiguous()), tag=tag), None


def pair_gather(feats: torch.Tensor, binning: Binning) -> torch.Tensor:
    return PairGather.apply(feats, binning)
