"""SuGaR renderers (port of the JAX package's ``renderers/sugar.py``:
``diff-sugar-rasterizer-normal`` and ``diff-sugar-rasterizer-shading``).

The geometry's mesh-bound Gaussians are rendered in the Gaussian
renderers' groups of views (the whole batch in one pass of the rasterizer,
or a view at a time, as their gate decides); one blend pass carries rgb,
the view depth and the Gaussians' face normals as extra channels, C = 7
(K1/K2 at 7 channels on the card).  Per view:

  * ``normal`` = clip(-extra * 0.5 + 0.5): the splatted face normals, the
    sign flipped to the reference's camera convention;
  * ``normal_from_dist`` (where the batch has ``rays_o``/``rays_d``): the
    screen-space normals of the depth's xyz map, * 0.5 alpha + 0.5;
  * ``-shading``: albedo = image / max(alpha, 1e-4) lit by the material
    with the splatted normals at the view's ``light_positions``, over the
    background.

The kernel background follows the Gaussian renderers' rule (inverted on a
draw in training, always at eval).  ``diff-sugar-rasterizer-temporal``
renders the dynamic SuGaR geometry (``models/dynamic_sugar.py``) at each
view's timestamp and frame index (0 and 0 where the batch has none), with
the deformation network's parameters in mode "deformation"; a group of
B > 1 views has each view's timed arrays stacked to (B, N, ...)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops.image import depth_to_normal, normalize_vec
from ..utils.registry import register
from .gaussian import GaussianRendererBase, stack_group


class SuGaRRendererBase(GaussianRendererBase):
    with_depth = True
    with_mask = True

    @staticmethod
    def state_device(gauss) -> torch.device:
        return gauss.params.points.device

    def view_arrays(self, sugar_state, color_clip: float, timestamp=None, frame_idx=None,
                    deformation_params=None) -> Dict[str, torch.Tensor]:
        """The rasterizer's arrays of one view: the mesh-bound Gaussians."""
        return self.geometry.as_gaussian_arrays(sugar_state, color_clip)

    def _batched_attrs(self, sugar_state, times, color_clip, override_color, deformation_params,
                       knots) -> Dict[str, Any]:
        """The mesh-bound Gaussians once, or a temporal renderer's arrays of
        each view at its time stacked to (B, N, ...); the face normals are
        the extra features (C = 7)."""
        if self.temporal:
            per_view = [self.view_arrays(sugar_state, color_clip, t["timestamp"],
                                         t["frame_idx"], deformation_params) for t in times]
            arrays = {k: stack_group([a[k] for a in per_view]) for k in per_view[0]}
        else:
            arrays = self.view_arrays(sugar_state, color_clip)
        return dict(
            means3d=arrays["means3d"], scales=arrays["scales"], quats=arrays["quats"],
            opacities=arrays["opacities"], sh_coeffs=arrays["sh_coeffs"],
            sh_degree=self.geometry.active_sh_degree, extra_features=arrays["normals"],
        )

    def _post_view(self, out: Dict[str, Any], *, bg_params=None, rays_o=None, rays_d=None,
                   light_positions=None, generator=None, ambient_only: bool = False,
                   training: bool = False, ambient_ratio=None, shading: Optional[str] = None,
                   draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        alpha = out["alpha"]
        depth = out["depth"]
        normal_splat = -out["extra"]
        result: Dict[str, Any] = {
            "render": torch.clamp(out["image"], 0.0, 1.0),
            "radii": out["radii"],
            "visibility_filter": out["visibility"],
            "n_dropped": out["n_dropped"],
            "n_pairs": out["n_pairs"],
            "mask": alpha,
            "depth": depth,
            "normal": torch.clamp(normal_splat * 0.5 + 0.5, 0.0, 1.0),
        }
        if rays_o is not None and rays_d is not None:
            nfd = normalize_vec(depth_to_normal(rays_o + depth[..., None] * rays_d))
            result["normal_from_dist"] = nfd * 0.5 * alpha[..., None] + 0.5
        if self.with_shading and self.material is not None:
            albedo = torch.clamp(out["image"] / torch.clamp_min(alpha[..., None], 1e-4), 0.0, 1.0)
            shaded = self.material.shade(
                rays_o + depth[..., None] * rays_d, normal_splat, light_positions, albedo,
                generator=generator, ambient_only=ambient_only, training=training,
                ambient_ratio=ambient_ratio, shading=shading, draws=draws,
            )
            comp = shaded * alpha[..., None]
            if self.background is not None:
                bg_color = self.background(bg_params, rays_d, generator=generator,
                                           training=training, draws=draws)
                comp = comp + (1.0 - alpha[..., None]) * bg_color
                result["comp_rgb_bg"] = bg_color
            result["render"] = torch.clamp(comp, 0.0, 1.0)
        return result


@register("diff-sugar-rasterizer-normal")
class DiffSugarRasterizerNormal(SuGaRRendererBase):
    pass


@register("diff-sugar-rasterizer-shading")
class DiffSugarRasterizerShading(SuGaRRendererBase):
    with_shading = True


@register("diff-sugar-rasterizer-temporal")
class DiffSugarRasterizerTemporal(SuGaRRendererBase):
    temporal = True

    def view_arrays(self, sugar_state, color_clip: float, timestamp=None, frame_idx=None,
                    deformation_params=None) -> Dict[str, torch.Tensor]:
        """The dynamic geometry's Gaussians at the view's time."""
        return self.geometry.get_timed_gs_arrays(
            sugar_state, 0.0 if timestamp is None else timestamp,
            0 if frame_idx is None else frame_idx, deformation_params, color_clip)
