"""Per-frame dynamic Gaussians (port of the JAX package's
``models/gaussian_dynamic.py``, ``gaussian-splatting-dynamic``): the
spacetime field with per-frame ``delta_xyz`` / ``delta_rot`` on by default
and the polynomial motion and spline off."""

from __future__ import annotations

from ..utils.registry import register
from .spacetime import SpacetimeConfig, SpacetimeGaussianField


@register("gaussian-splatting-dynamic")
class GaussianDynamicModel(SpacetimeGaussianField):
    Config = SpacetimeConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if isinstance(cfg, dict):
            cfg = dict(cfg)
            cfg.setdefault("enable_dynamic", True)
            cfg.setdefault("enable_spacetime", False)
            cfg.setdefault("use_spline", False)
        super().__init__(cfg, device, **kwargs)
