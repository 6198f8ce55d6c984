"""Multi-view (MVDream / ImageDream) system (port of the JAX package's
``systems/gaussian_mvdream.py``): the text-to-3D loss set, whose sparsity
term reads comp_mask.  The JAX system's predicted-normal MSE needs the
renderer's ``comp_pred_normal``, which waits for ``pred_normal`` (ROADMAP
queue 1, item 4); no shipped YAML turns it on."""

from __future__ import annotations

from ..utils.registry import register
from .gaussian_splatting import GaussianSplattingSystem


@register("gaussian-splatting-mvdream-system")
class MVDreamSystem(GaussianSplattingSystem):
    """The text-to-3D system under the multi-view YAMLs' name."""
