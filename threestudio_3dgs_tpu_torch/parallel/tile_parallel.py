"""Tile-sharded (intra-view) rendering on ``torch.distributed`` (port of the
JAX package's ``parallel/tile_parallel.py``).

Each rank renders one horizontal band of tile rows of a single view against
the replicated Gaussians (``rasterize(..., tile_band=(row0, rows))``): the
projection runs against the full camera, so means2d, conics and radii are
the full render's, and the band's pixels hold exactly the pairs whose tiles
fall inside it, in the same per-tile depth order.  The inputs pass through
``ReplicatedInputs``, the identity forward whose backward all-reduces (SUM)
each input's gradient over the group: the port's form of the ``shard_map``
transpose of replicated inputs, which sums the bands' per-Gaussian
gradients into the full render's on every rank.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from ..ops.rasterizer import RasterizeConfig, rasterize


class ReplicatedInputs(torch.autograd.Function):
    """Identity forward; the backward all-reduces (SUM) every input's
    gradient over ``group``, in argument order (one collective an input,
    the same order on every rank)."""

    @staticmethod
    def forward(ctx, group, *inputs):
        ctx.group = group
        return tuple(x.view_as(x) for x in inputs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
            out.append(g)
        return (None, *out)


def union_visibility(visibility: torch.Tensor, group) -> torch.Tensor:
    """A Gaussian is visible where any rank's band sees it (all_reduce MAX
    on int32)."""
    v = visibility.to(torch.int32)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
    return v > 0


def reduce_count(n: int, op, group, device) -> int:
    t = torch.tensor([int(n)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=op, group=group)
    return int(t)


def make_tile_parallel_rasterize(
    group,
    camera,
    bg_color: torch.Tensor,
    with_depth: bool = True,
    config: RasterizeConfig = RasterizeConfig(),
):
    """A single-view renderer over ``group``: Gaussians replicated, the
    image's tile rows split into one band a rank.  Returns
    f(means3d, scales, quats, opacities, colors) -> dict with this rank's
    band of image (H / world, W, 3), alpha and depth, the full view's radii,
    the bands' union of visibility, n_pairs (the largest band's) and
    n_dropped (the bands' sum).  Differentiable: the inputs' gradients are
    the sum of every band's.  ``gather_bands`` assembles the whole view."""
    world = dist.get_world_size(group)
    ts = config.tile_size
    assert camera.height % (ts * world) == 0, (
        f"height {camera.height} must split into {world} tile-row bands")
    band_rows = camera.height // ts // world
    row0 = dist.get_rank(group) * band_rows

    def band_render(means3d, scales, quats, opacities, colors) -> Dict[str, Any]:
        means3d, scales, quats, opacities, colors = ReplicatedInputs.apply(
            group, means3d, scales, quats, opacities, colors)
        out = rasterize(means3d, scales, quats, opacities, camera, bg_color, colors=colors,
                        with_depth=with_depth, config=config, tile_band=(row0, band_rows))
        res = {
            "image": out["image"],
            "alpha": out["alpha"],
            "radii": out["radii"],
            "visibility": union_visibility(out["visibility"], group),
            "n_pairs": reduce_count(out["n_pairs"], dist.ReduceOp.MAX, group, means3d.device),
            "n_dropped": reduce_count(out["n_dropped"], dist.ReduceOp.SUM, group,
                                      means3d.device),
        }
        if with_depth:
            res["depth"] = out["depth"]
        return res

    return band_render


def gather_bands(out: Dict[str, Any], group, dim: int = 0) -> Dict[str, torch.Tensor]:
    """The whole view's image, alpha and depth from every rank's band
    (all_gather along ``dim``, the bands' row axis), without gradient."""
    world = dist.get_world_size(group)
    whole = {}
    for k in ("image", "alpha", "depth"):
        if k in out:
            x = out[k].detach().contiguous()
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x, group=group)
            whole[k] = torch.cat(parts, dim=dim)
    return whole
