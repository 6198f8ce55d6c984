"""Hybrid 2-D mesh rendering: cameras sharded on one axis, image tile rows
on the other (port of the JAX package's ``parallel/hybrid.py``).

On a (data, tile) ``DeviceMesh`` rank (i, j) renders tile-row band j of
camera shard i against the replicated Gaussians, view by view.  Camera
parallelism amortises the batch, tile parallelism splits one view; the
inputs' gradients all-reduce over the whole mesh (``ReplicatedInputs`` on
the default group, which the mesh spans), as the JAX package's
``shard_map`` transpose psums them over both axes.  Each band holds exactly
the pairs whose tiles fall inside it, in the same per-tile depth order.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.distributed as dist

from ..ops.rasterizer import RasterizeConfig, rasterize
from .tile_parallel import ReplicatedInputs, gather_bands, reduce_count, union_visibility


def make_hybrid_rasterize(
    mesh,
    cameras: Sequence,  # B cameras of one size
    bg_color: torch.Tensor,
    data_axis: str = "data",
    tile_axis: str = "tile",
    with_depth: bool = True,
    config: RasterizeConfig = RasterizeConfig(),
):
    """A batch renderer over a 2-D ``DeviceMesh`` that spans every rank.
    Returns f(means3d, scales, quats, opacities, colors) -> dict with this
    rank's views and band: image (B / n_data, H / n_tile, W, 3), alpha and
    depth likewise, radii (B / n_data, N), visibility (B / n_data, N) unioned
    over the tile axis, n_pairs (the largest rank's sum over its views, over
    the mesh) and n_dropped (the sum over the mesh).  Differentiable: the
    inputs' gradients sum over the whole mesh.  ``gather_views`` assembles
    the whole batch."""
    b = len(cameras)
    n_cam = mesh.size(mesh.mesh_dim_names.index(data_axis))
    n_band = mesh.size(mesh.mesh_dim_names.index(tile_axis))
    assert b % n_cam == 0, (b, n_cam)
    assert n_cam * n_band == dist.get_world_size(), "the mesh must span every rank"
    local_b = b // n_cam
    height = cameras[0].height
    ts = config.tile_size
    assert height % (ts * n_band) == 0, (
        f"height {height} must split into {n_band} tile-row bands")
    band_rows = height // ts // n_band
    data_group, tile_group = mesh.get_group(data_axis), mesh.get_group(tile_axis)
    ci = dist.get_rank(data_group)
    r0 = dist.get_rank(tile_group) * band_rows
    views = [cameras[ci * local_b + v] for v in range(local_b)]

    def device_render(means3d, scales, quats, opacities, colors) -> Dict[str, Any]:
        means3d, scales, quats, opacities, colors = ReplicatedInputs.apply(
            None, means3d, scales, quats, opacities, colors)
        outs = [rasterize(means3d, scales, quats, opacities, cam, bg_color, colors=colors,
                          with_depth=with_depth, config=config, tile_band=(r0, band_rows))
                for cam in views]
        vis = union_visibility(torch.stack([o["visibility"] for o in outs]), tile_group)
        device = means3d.device
        res = {
            "image": torch.stack([o["image"] for o in outs]),
            "alpha": torch.stack([o["alpha"] for o in outs]),
            "radii": torch.stack([o["radii"] for o in outs]),
            "visibility": vis,
            "n_pairs": reduce_count(sum(o["n_pairs"] for o in outs), dist.ReduceOp.MAX, None,
                                    device),
            "n_dropped": reduce_count(sum(o["n_dropped"] for o in outs), dist.ReduceOp.SUM,
                                      None, device),
        }
        if with_depth:
            res["depth"] = torch.stack([o["depth"] for o in outs])
        return res

    return device_render


def gather_views(out: Dict[str, Any], mesh, data_axis: str = "data",
                 tile_axis: str = "tile") -> Dict[str, torch.Tensor]:
    """The whole batch's image, alpha and depth (B, H, W, ...) from every
    rank's views and band: all_gather along H over the tile axis, then
    along B over the data axis; without gradient."""
    rows = gather_bands(out, mesh.get_group(tile_axis), dim=1)
    return gather_bands(rows, mesh.get_group(data_axis), dim=0)
