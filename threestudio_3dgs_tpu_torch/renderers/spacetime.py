"""Temporal (4D) renderer, ``diff-gaussian-rasterizer-spacetime`` (port of
the JAX package's ``renderers/spacetime.py``).

Each view evaluates the spacetime field at its own timestamp and frame
index (polynomial, per-frame, deformation or spline motion; see
``models/spacetime.py``) and rasterizes the precomputed colours SH2RGB(f_dc)
with depth and the alpha mask.  A view without a timestamp renders at t = 0,
frame 0.  In spline mode the knots are computed once per batch (they do not
depend on the view).  Each view's evaluation, and a batch's knots, runs in
a ``render/timed`` span, so a trace counts the evaluations.  The batch
renders view by view or, under the Gaussian renderers' gate, in one pass of
the rasterizer with each view's timed attributes stacked to (B, N, ...)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops import camera as cam_ops
from ..ops.rasterizer import RasterizeConfig, rasterize
from ..utils.registry import register
from ..utils.tracing import span
from .gaussian import GaussianRendererBase


@register("diff-gaussian-rasterizer-spacetime")
class DiffGaussianRasterizerSpacetime(GaussianRendererBase):
    with_depth = True
    with_mask = True
    temporal = True

    def batch_forward(self, gauss, batch: Dict[str, Any], *, deformation_params=None,
                      knots=None, **kwargs) -> Dict[str, Any]:
        if knots is None and self.geometry.cfg.use_spline:
            with span("render/timed"):
                knots = self.geometry.control_knots(gauss, deformation_params)
        return super().batch_forward(gauss, batch, deformation_params=deformation_params,
                                     knots=knots, **kwargs)

    def _timed(self, gauss, timestamp, frame_idx, deformation_params, knots):
        """The field's activated attributes at the view's time (t = 0,
        frame 0 where it has none), in a ``render/timed`` span."""
        with span("render/timed"):
            return self.geometry.get_timed_all(
                gauss, 0.0 if timestamp is None else timestamp,
                0 if frame_idx is None else frame_idx, deformation_params, knots)

    def _batched_attrs(self, gauss, times, color_clip, override_color, deformation_params,
                       knots) -> Dict[str, Any]:
        """Each view's timed attributes (one ``get_timed_all`` a view at
        its timestamp and frame index) stacked to (B, N, ...)."""
        timed = [self._timed(gauss, t["timestamp"], t["frame_idx"], deformation_params, knots)
                 for t in times]
        means3d, scales, rotations, opacity, colors = (list(a) for a in zip(*timed))
        if override_color is not None:
            colors = [override_color] * len(times)
        return dict(
            means3d=torch.stack(means3d),
            scales=torch.stack(scales),
            quats=torch.stack(rotations),
            opacities=torch.stack(opacity)[..., 0],
            colors=torch.stack(colors),
            alive=gauss.alive,
        )

    def render_one(
        self,
        gauss,
        camera: cam_ops.Camera,
        *,
        generator: Optional[torch.Generator] = None,
        training: bool = False,
        means2d_offset: Optional[torch.Tensor] = None,
        override_color: Optional[torch.Tensor] = None,
        scaling_modifier: float = 1.0,
        draws: Optional[Dict[str, Any]] = None,
        timestamp=None,
        frame_idx=None,
        deformation_params=None,
        knots=None,
        **unused,
    ) -> Dict[str, Any]:
        """``unused``: the static renderers' channel arguments (background,
        rays, lights, shading, color_clip), which this renderer has no use
        for."""
        device = gauss.params.xyz.device
        kernel_bg = self._kernel_bg(generator, training, device, draws)
        means3d, scales, rotations, opacity, colors = self._timed(
            gauss, timestamp, frame_idx, deformation_params, knots)
        if override_color is not None:
            colors = override_color
        out = rasterize(
            means3d, scales, rotations, opacity[:, 0], camera, kernel_bg, colors=colors,
            alive=gauss.alive, means2d_offset=means2d_offset, scaling_modifier=scaling_modifier,
            config=RasterizeConfig(tile_size=self.cfg.tile_size, max_pairs=self.pair_capacity),
        )
        return {
            "render": torch.clamp(out["image"], 0.0, 1.0),
            "radii": out["radii"],
            "visibility_filter": out["visibility"],
            "n_dropped": out["n_dropped"],
            "n_pairs": out["n_pairs"],
            "mask": out["alpha"],
            "depth": out["depth"],
        }
