"""Static Gaussian renderer and its variants (port of the JAX package's
``renderers/gaussian.py``: ``GaussianRendererBase``,
``diff-gaussian-rasterizer`` and its ``-advanced``, ``-background``,
``-normal`` and ``-shading`` variants).

A batch renders in groups of views, each group in one pass of the
rasterizer (``rasterize_batched``: the group's views stacked as tile rows
of one grid, one pair capacity of len(group) x the per-view capacity
shared by all).  The JAX package's gate decides the grouping: the whole
batch is one group where ``batched`` is on, B > 1, the per-view capacity
is at most ``batched_max_pairs`` and the JAX package's packed sort key can
hold the pair pool (``_batched_key_fits``); else each view is a group of
its own.  So the gate decides which capacity drops pairs and what n_pairs
reports, not how a view is rendered.  The per-view capacity is
``max_pairs``, or the system's adaptive capacity (``max_pairs_override``,
systems/base.py) when it sets one.  A renderer states its scene arguments
for a group in ``_batched_attrs``.  Every variant blends rgb and depth in
one pass (C = 4) and post-processes each view:

  * ``-advanced``: depth and alpha mask;
  * ``-background``: the kernel background is zero and the neural
    background (``SystemState.extra_params["background"]``, evaluated on the
    view's ``rays_d``) is composited outside the kernel;
  * ``-normal``: depth -> xyz through the view's ``rays_o``/``rays_d`` ->
    screen-space normals, with the gradient of the normals and the depth
    stopped where alpha <= 0.99; a field with ``pred_normal`` has its
    per-Gaussian normal blended as three more channels in the same pass
    (C = 7), returned as ``pred_normal`` (the ``-shading`` variant too);
  * ``-shading``: albedo = image / max(alpha, 1e-4), lit by the material at
    the view's ``light_positions``, composited over the neural background.

Output keys mirror the reference batch renderer: comp_rgb (B, H, W, 3),
comp_depth, comp_mask (B, H, W, 1), comp_normal, comp_pred_normal,
comp_rgb_bg (B, H, W, 3)
where the variant has them, the per-view stacked radii / visibility_filter
and the per-view pair counts n_pairs / n_dropped (each view's share of
its group's totals, rounded up, as the JAX package reports them).

Draws (the kernel background's inversion, the neural background's
augmentation, the material's) come from the step's generator, view by view
in that order however the views are grouped; the test-only ``draws``
keyword (one dict per view) feeds them in instead, and so do a batch's
``view_draws/<name>``
entries (``batch_view_draws``: the whole camera batch's draws, taken in the
same order, which the data-parallel step shards with the cameras so that a
view's draws do not depend on the rank that renders it).  A renderer's
``path_counts`` counts the gate's decision for each of its
``batch_forward`` calls: "batched" (one group) or "loop" (groups of one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import gaussian_field as gf
from ..ops import camera as cam_ops
from ..ops.image import depth_to_normal, normalize_vec
from ..ops.rasterizer import RasterizeConfig, rasterize_batched
from ..utils.config import parse_structured
from ..utils.draws import uniforms
from ..utils.registry import register

VIEW_DRAWS = "view_draws/"  # batch entries (B, n): each view's uniforms by name


@dataclasses.dataclass
class RendererConfig:
    invert_bg_prob: float = 1.0
    back_ground_color: Tuple[float, float, float] = (1, 1, 1)
    tile_size: int = 32
    max_pairs: int = 2**21  # ceiling; pair buffers are sized per frame below it
    # bucketed pair capacity between min_pairs and max_pairs, set by the
    # system's controller (systems/base.py) where its train step runs it
    adaptive_max_pairs: bool = False
    min_pairs: int = 256 * 1024
    # the camera batch in one pass of the rasterizer where the gate in
    # batch_forward allows it, else one pass a view
    batched: bool = True
    # the largest per-view capacity the single pass takes
    batched_max_pairs: int = 256 * 1024


def stack_group(arrays: List[torch.Tensor]) -> torch.Tensor:
    """A group's per-view arrays stacked on a leading view axis; a group of
    one gives its view's array as it is."""
    return torch.stack(arrays) if len(arrays) > 1 else arrays[0]


def _view_tensor(batch, key: str, i: int, device) -> Optional[torch.Tensor]:
    """View i of a batch entry (numpy or tensor) as an f32 tensor on
    ``device``, or None when the batch has no such entry.  An entry with
    fewer rows than views gives its last row, as JAX's clamped indexing
    does (the temporal data's single light position)."""
    if key not in batch:
        return None
    entry = batch[key]
    return torch.as_tensor(entry[min(i, len(entry) - 1)], dtype=torch.float32, device=device)


class GaussianRendererBase:
    """Shared machinery.  Subclasses set class flags for channels."""

    Config = RendererConfig
    # the system's adaptive per-view capacity, when it sets one
    max_pairs_override: Optional[int] = None
    with_depth = False
    with_mask = False
    with_normal = False
    with_background = False
    with_shading = False
    # evaluates the field at each view's timestamp / frame index
    temporal = False

    def __init__(self, cfg=None, geometry=None, material=None, background=None, **kw):
        if cfg is None:
            cfg = RendererConfig(**kw)
        elif isinstance(cfg, dict):
            cfg = parse_structured(RendererConfig, cfg)
        self.cfg = cfg
        self.geometry = geometry
        self.material = material
        self.background = background
        # (path, training) -> batch_forward calls that took it; path
        # "batched" (one group of views) or "loop" (groups of one)
        self.path_counts: Dict[Tuple[str, bool], int] = {}
        # device -> back_ground_color as an f32 tensor there
        self._base_bgs: Dict[str, torch.Tensor] = {}

    @property
    def pair_capacity(self) -> int:
        """The per-view pair capacity: the system's override, else max_pairs."""
        return self.max_pairs_override or self.cfg.max_pairs

    def _batched_key_fits(self, bs: int, per_view_cap: int, height: int, width: int) -> bool:
        """The JAX package's test that its packed int32 tile-sort key
        (tile << pair_bits | pair) holds the single pass's bs * cap pair
        pool over bs * grid tiles: pair_bits + tile_bits <= 31.  The port's
        int64 keys hold any pool, but the test decides which path runs, so
        which capacity drops pairs and what n_pairs reports: the port
        follows the JAX package's rule as written."""
        ts = self.cfg.tile_size
        num_tiles = bs * ((width + ts - 1) // ts) * ((height + ts - 1) // ts)
        pair_bits = max(int(bs * per_view_cap - 1).bit_length(), 1)
        return pair_bits + int(num_tiles).bit_length() <= 31

    def use_batched(self, bs: int, height: int, width: int) -> bool:
        """The JAX package's gate of the single-pass batched render: true
        renders the batch as one group of views, false a view at a time."""
        cap = self.pair_capacity
        return (self.cfg.batched and bs > 1 and cap <= self.cfg.batched_max_pairs
                and self._batched_key_fits(bs, cap, height, width))

    def view_draw_sizes(self) -> Dict[str, int]:
        """The uniforms a training view of ``batch_forward`` takes from the
        generator, by name, in the order it takes them: the kernel
        background's inversion, then (in the view's post-processing) the
        neural background's augmentation and the material's shading."""
        sizes = {} if self.with_background else {"invert_bg": 1}
        if self.with_background and self.background is not None:
            if getattr(self.background.cfg, "random_aug", False):
                sizes["bg_aug"] = 2
        if self.with_shading and self.material is not None:
            if self.material.cfg.soft_shading:
                sizes["soft"] = 1
            sizes["mode"] = 2
        return sizes

    def batch_view_draws(self, generator: torch.Generator, bs: int) -> Dict[str, torch.Tensor]:
        """The draws a training ``batch_forward`` of ``bs`` views would take
        from ``generator``, taken now in its order, as batch entries
        ``view_draws/<name>`` of shape (bs, n), which ``batch_forward``
        then reads instead of the generator."""
        sizes = self.view_draw_sizes()
        per_view = [{name: torch.rand((n,), generator=generator, device=generator.device)
                     for name, n in sizes.items()} for _ in range(bs)]
        return {VIEW_DRAWS + name: torch.stack([d[name] for d in per_view]) for name in sizes}

    def _kernel_bg(self, generator: Optional[torch.Generator], training: bool, device,
                   draws: Optional[Dict[str, Any]] = None):
        """Per-view kernel background colour: zero under a neural background
        (composited outside the kernel); else training inverts it when a
        uniform draw exceeds invert_bg_prob, and eval always inverts
        (reference quirk)."""
        if self.with_background:
            return torch.zeros(3, device=device)
        base_bg = self._base_bgs.get(str(device))
        if base_bg is None:
            base_bg = self._base_bgs[str(device)] = torch.tensor(
                self.cfg.back_ground_color, dtype=torch.float32, device=device)
        if training and (generator is not None or draws):
            draw = uniforms(draws, "invert_bg", 1, generator, device)
            return torch.where(draw > self.cfg.invert_bg_prob, 1.0 - base_bg, base_bg)
        return 1.0 - base_bg

    def _post_view(
        self,
        out: Dict[str, Any],
        *,
        bg_params=None,
        rays_o=None,
        rays_d=None,
        light_positions=None,
        generator=None,
        ambient_only: bool = False,
        training: bool = False,
        ambient_ratio=None,
        shading: Optional[str] = None,
        draws: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Channel post-processing of one view's rasterizer output
        (background composite, depth -> normal, material shading)."""
        result: Dict[str, Any] = {
            "render": torch.clamp(out["image"], 0.0, 1.0),
            "radii": out["radii"],
            "visibility_filter": out["visibility"],
            "n_dropped": out["n_dropped"],
            "n_pairs": out["n_pairs"],
        }
        alpha = out["alpha"][..., None]
        depth = out["depth"]
        if self.with_mask:
            result["mask"] = out["alpha"]
        if self.with_depth:
            result["depth"] = depth

        bg_color = None
        if self.with_background and self.background is not None:
            bg_color = self.background(bg_params, rays_d, generator=generator, training=training,
                                       draws=draws)  # (H, W, 3)
            result["render"] = torch.clamp(out["image"] + (1.0 - alpha) * bg_color, 0.0, 1.0)
            result["comp_rgb_bg"] = bg_color

        if self.with_normal:
            xyz_map = rays_o + depth[..., None] * rays_d
            normal_map = normalize_vec(depth_to_normal(xyz_map)) * 0.5 * alpha + 0.5
            confident = alpha > 0.99  # gradients flow only where the render is opaque
            result["normal"] = torch.where(confident, normal_map, normal_map.detach())
            result["depth"] = torch.where(confident[..., 0], depth, depth.detach())
            if "extra" in out:
                # the field's predicted normals, blended in the same pass
                result["pred_normal"] = out["extra"]

        if self.with_shading and self.material is not None:
            albedo = torch.clamp(out["image"] / torch.clamp_min(alpha, 1e-4), 0.0, 1.0)
            shaded = self.material.shade(
                rays_o + depth[..., None] * rays_d, result["normal"] * 2.0 - 1.0,
                light_positions, albedo, generator=generator, ambient_only=ambient_only,
                training=training, ambient_ratio=ambient_ratio, shading=shading, draws=draws,
            )
            comp = shaded * alpha
            if bg_color is not None:
                comp = comp + (1.0 - alpha) * bg_color
            result["render"] = torch.clamp(comp, 0.0, 1.0)
        return result

    def batch_forward(
        self,
        gauss: gf.GaussianState,
        batch: Dict[str, Any],
        *,
        bg_params=None,
        generator: Optional[torch.Generator] = None,
        ambient_only: bool = False,
        training: bool = False,
        color_clip: float = float("inf"),
        means2d_offset: Optional[torch.Tensor] = None,  # (B, N, 2) zeros
        override_color=None,
        ambient_ratio=None,
        shading: Optional[str] = None,
        draws: Optional[List[Dict[str, Any]]] = None,  # one dict per view
        deformation_params=None,
        knots=None,
    ) -> Dict[str, Any]:
        """Every view of the batch; a temporal renderer also gets the
        view's ``timestamp`` and ``frame_idx`` (None where the batch has
        none), the deformation parameters and the spline knots."""
        c2w = batch["c2w"]
        bs = c2w.shape[0]
        height, width = int(batch["height"]), int(batch["width"])
        device = self.state_device(gauss)
        names = [k for k in batch if k.startswith(VIEW_DRAWS)]
        if draws is None and names:
            draws = [{k[len(VIEW_DRAWS):]: batch[k][i] for k in names} for i in range(bs)]
        cameras, times, views = [], [], []
        for i in range(bs):
            fovy = float(batch["fovy"][i])
            cameras.append(cam_ops.camera_from_c2w(
                c2w[i], fovy, fovy, height, width, znear=0.1, zfar=100.0, device=device
            ))  # fovx = fovy, as the reference batch renderer passes
            times.append(dict(
                timestamp=batch["timestamp"][i] if "timestamp" in batch else None,
                frame_idx=batch["frame_indices"][i] if "frame_indices" in batch else None,
            ))
            views.append(dict(
                bg_params=bg_params,
                rays_o=_view_tensor(batch, "rays_o", i, device),
                rays_d=_view_tensor(batch, "rays_d", i, device),
                light_positions=_view_tensor(batch, "light_positions", i, device),
                generator=generator,
                ambient_only=ambient_only,
                training=training,
                ambient_ratio=ambient_ratio,
                shading=shading,
                draws=None if draws is None else draws[i],
            ))
        path = "batched" if self.use_batched(bs, height, width) else "loop"
        self.path_counts[(path, training)] = self.path_counts.get((path, training), 0) + 1
        # (views, their means2d_offset): the whole batch with the tensor as it
        # is (a slice's backward would allocate zeros of its full size), or
        # view i with its (N, 2) rows
        if path == "batched":
            groups = [(slice(0, bs), means2d_offset)]
        else:
            groups = [(slice(i, i + 1), None if means2d_offset is None else means2d_offset[i])
                      for i in range(bs)]
        per_view = []
        for g, offset in groups:
            attrs = self._batched_attrs(gauss, times[g], color_clip, override_color,
                                        deformation_params, knots)
            per_view += self._render_group(cameras[g], views[g], attrs, offset)
        return self._stack_views(per_view)

    def _batched_attrs(self, gauss, times, color_clip, override_color, deformation_params,
                       knots) -> Dict[str, Any]:
        """``rasterize_batched``'s scene arguments for a group of views:
        the static field's, shared by the views.  Renderers with per-view
        attributes (the timed fields) override it; ``times`` holds each of
        the group's views' timestamp and frame index."""
        geo = self.geometry
        params = gauss.params
        sh_coeffs = None
        colors = override_color
        if colors is None:
            sh_coeffs = gf.get_features(params, color_clip)
        return dict(
            means3d=params.xyz,
            scales=gf.get_scaling(params, geo.cfg.sphere if geo is not None else False),
            quats=params.rotation,
            opacities=gf.get_opacity(params)[:, 0],
            colors=colors,
            sh_coeffs=sh_coeffs,
            sh_degree=geo.active_sh_degree if geo is not None else 0,
            extra_features=params.normal if self.with_normal else None,
            alive=gauss.alive,
        )

    def _render_group(self, cameras, views, attrs, means2d_offset) -> List[Dict[str, Any]]:
        """One rasterizer pass for a group of views over one shared pool of
        len(group) x the per-view capacity, then each view's post-processing;
        per-view n_pairs / n_dropped are each view's share of the totals,
        rounded up (so the controller sees the pool's demand and any drop;
        a group of one reports the view's own).  The kernel background is
        composited per view after the pass: the pass draws nothing, so the
        generator's draws come view by view (the kernel background's, then
        the post-processing's) however the views are grouped, and the
        groupings give the same numbers under one seed."""
        bs = len(cameras)
        device = cameras[0].campos.device
        out = rasterize_batched(
            cameras=cameras,
            bg_color=None,  # each view's is composited below
            means2d_offset=means2d_offset,
            with_depth=True,
            config=RasterizeConfig(tile_size=self.cfg.tile_size,
                                   max_pairs=self.pair_capacity * bs),
            **attrs,
        )
        n_pairs_v = -(-out["n_pairs"] // bs)
        n_dropped_v = -(-out["n_dropped"] // bs)
        # each view's arrays: one unbind a key, whose backward stacks the
        # views' gradients (a select's would zero-fill the group's a view);
        # a group of one squeezes, whose backward is a view
        arrays = {k: out[k].unbind(0) if bs > 1 else (out[k].squeeze(0),)
                  for k in ("image", "alpha", "depth", "radii", "visibility", "extra")
                  if k in out}
        per_view = []
        for i, view in enumerate(views):
            kernel_bg = self._kernel_bg(view["generator"], view["training"], device,
                                        view["draws"])
            view_out = {k: a[i] for k, a in arrays.items()}
            alpha = view_out["alpha"][..., None]
            view_out["image"] = view_out["image"] + (1.0 - alpha) * kernel_bg
            view_out.update(n_pairs=n_pairs_v, n_dropped=n_dropped_v)
            per_view.append(self._post_view(view_out, **view))
        return per_view

    @staticmethod
    def state_device(gauss) -> torch.device:
        return gauss.params.xyz.device

    @staticmethod
    def _stack_views(per_view) -> Dict[str, Any]:
        outputs: Dict[str, Any] = {
            "comp_rgb": torch.stack([o["render"] for o in per_view]),
            "radii": torch.stack([o["radii"] for o in per_view]),
            "visibility_filter": torch.stack([o["visibility_filter"] for o in per_view]),
            "n_dropped": torch.tensor([o["n_dropped"] for o in per_view]),
            "n_pairs": torch.tensor([o["n_pairs"] for o in per_view]),
        }
        for name, out_name in (("depth", "comp_depth"), ("mask", "comp_mask"),
                               ("normal", "comp_normal"), ("pred_normal", "comp_pred_normal"),
                               ("normal_from_dist", "comp_normal_from_dist"),
                               ("comp_rgb_bg", "comp_rgb_bg")):
            if name in per_view[0]:
                stacked = torch.stack([o[name] for o in per_view])
                outputs[out_name] = stacked[..., None] if stacked.dim() == 3 else stacked
        return outputs


@register("diff-gaussian-rasterizer")
class DiffGaussianRasterizer(GaussianRendererBase):
    """Vanilla render: rgb only."""


@register("diff-gaussian-rasterizer-advanced")
class DiffGaussianRasterizerAdvanced(GaussianRendererBase):
    """Also returns depth and the alpha mask."""

    with_depth = True
    with_mask = True


@register("diff-gaussian-rasterizer-background")
class DiffGaussianRasterizerBackground(GaussianRendererBase):
    """The neural background composited over a zero-background render."""

    with_depth = True
    with_mask = True
    with_background = True


@register("diff-gaussian-rasterizer-normal")
class DiffGaussianRasterizerNormal(GaussianRendererBase):
    """Depth-derived screen-space normals."""

    with_depth = True
    with_mask = True
    with_normal = True


@register("diff-gaussian-rasterizer-shading")
class DiffGaussianRasterizerShading(GaussianRendererBase):
    """Normals, point-light shading by the material, and the neural
    background."""

    with_depth = True
    with_mask = True
    with_normal = True
    with_shading = True
    with_background = True
