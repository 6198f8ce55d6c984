"""Temporal (4D) renderer, ``diff-gaussian-rasterizer-spacetime`` (port of
the JAX package's ``renderers/spacetime.py``).

Each view evaluates the spacetime field at its own timestamp and frame
index (polynomial, per-frame, deformation or spline motion; see
``models/spacetime.py``) and rasterizes the precomputed colours SH2RGB(f_dc)
with depth and the alpha mask.  A view without a timestamp renders at t = 0,
frame 0.  In spline mode the knots are computed once per batch (they do not
depend on the view).  Each view's evaluation, and a batch's knots, runs in
a ``render/timed`` span, so a trace counts the evaluations.  The views
render in the Gaussian renderers' groups (the whole batch, or a view at a
time, as their gate decides), each view's timed attributes stacked to
(B, N, ...) for a group of B > 1."""

from __future__ import annotations

from typing import Any, Dict

from ..utils.registry import register
from ..utils.tracing import span
from .gaussian import GaussianRendererBase, stack_group


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
        its timestamp and frame index) stacked to (B, N, ...); the
        precomputed colours SH2RGB(f_dc), or ``override_color``."""
        timed = [self._timed(gauss, t["timestamp"], t["frame_idx"], deformation_params, knots)
                 for t in times]
        means3d, scales, rotations, opacity, colors = (list(a) for a in zip(*timed))
        if override_color is not None:
            colors = [override_color] * len(times)
        return dict(
            means3d=stack_group(means3d),
            scales=stack_group(scales),
            quats=stack_group(rotations),
            opacities=stack_group(opacity)[..., 0],
            colors=stack_group(colors),
            alive=gauss.alive,
        )
