"""Fixed-capacity Gaussian field (port of the JAX package's
``models/gaussian_field.py``).

The field lives in tensors of static capacity with an ``alive`` mask, so a
port state compares row for row with the JAX package's.  Here: the
parameters and activations, the initialisations (the random sphere, a
checkpoint or PLY warm start, a plain point cloud, the prompt fallback;
an unrecognised ``geometry_convert_from`` raises where the JAX package
falls back to the sphere), the per-field learning rates, the Adam step,
the densification statistics, the structural ops (clone / split / prune /
cap-prune / opacity reset / SuGaR prune as masked scatters into free
slots, Adam moments zeroed with the rows they rewrite), their interval
gating and the PLY export.

A structural op returns a new state and leaves the state it was given
untouched.  Its random draws come from a ``torch.Generator``; the test-only
``draws`` keyword replaces them (the parity tests feed the JAX package's
draws).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import knn as knn_ops
from ..ops import quaternion
from ..ops.gaussian_math import inverse_sigmoid
from ..ops.sh import num_sh_bases, rgb_to_sh
from ..utils.config import C, parse_structured
from ..utils.registry import register
from . import ply_io
from .optim import (
    AdamState, adam_update, clone_adam, init_adam, row_mask, zero_moments_field,
    zero_moments_where,
)

PARAM_FIELDS = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "normal",
)
STAT_FIELDS = ("max_radii2d", "xyz_grad_accum", "denom")


@dataclasses.dataclass
class GaussianParams:
    """Learnable per-Gaussian parameters, all (CAP, ...) float32.  A
    subclass with more fields (the spacetime field's) names them all in
    ``FIELDS``; the structural ops keep the subclass."""

    FIELDS = PARAM_FIELDS

    xyz: torch.Tensor  # (CAP, 3)
    features_dc: torch.Tensor  # (CAP, 1, 3)
    features_rest: torch.Tensor  # (CAP, K-1, 3)
    scaling: torch.Tensor  # (CAP, 3) log-scale
    rotation: torch.Tensor  # (CAP, 4) wxyz, unnormalised
    opacity: torch.Tensor  # (CAP, 1) logit
    normal: Optional[torch.Tensor] = None  # (CAP, 3) if pred_normal

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS if getattr(self, k) is not None}


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    adam: AdamState
    alive: torch.Tensor  # (CAP,) bool
    max_radii2d: torch.Tensor  # (CAP,) f32
    xyz_grad_accum: torch.Tensor  # (CAP,) f32, accumulated NDC grad norms
    denom: torch.Tensor  # (CAP,) f32

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())


@dataclasses.dataclass
class GaussianFieldConfig:
    """Mirrors the JAX package's GaussianFieldConfig."""

    max_num: int = 500000
    capacity: Optional[int] = None  # static capacity; default ~1.3 * max_num
    sh_degree: int = 0
    position_lr: Any = 0.001
    feature_lr: Any = 0.01
    opacity_lr: Any = 0.05
    scaling_lr: Any = 0.005
    rotation_lr: Any = 0.005
    pred_normal: bool = False
    normal_lr: Any = 0.001
    scale_lr: Any = 0.003  # present in the reference config, unused

    densification_interval: int = 50
    prune_interval: int = 50
    opacity_reset_interval: int = 100000
    densify_from_iter: int = 100
    prune_from_iter: int = 100
    densify_until_iter: int = 2000
    prune_until_iter: int = 2000
    densify_grad_threshold: Any = 0.01
    min_opac_prune: Any = 0.005
    split_thresh: Any = 0.02
    radii2d_thresh: Any = 1000

    sphere: bool = False
    prune_big_points: bool = False
    color_clip: Any = 2.0

    geometry_convert_from: str = ""
    load_ply_only_vertex: bool = False
    load_vertex_only_position: bool = False
    init_num_pts: int = 100
    pc_init_radius: float = 0.8
    opacity_init: float = 0.1

    sugar_prune_at: Any = None
    sugar_prune_threshold: float = 0.5

    def resolved_capacity(self) -> int:
        if self.capacity is not None:
            return int(self.capacity)
        return int(self.max_num * 1.3) + 1024


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def get_scaling(params: GaussianParams, sphere: bool = False) -> torch.Tensor:
    if sphere:
        mean = torch.mean(params.scaling, dim=-1, keepdim=True)
        return torch.exp(mean.expand_as(params.scaling))
    return torch.exp(params.scaling)


def get_rotation(params: GaussianParams) -> torch.Tensor:
    return quaternion.normalize(params.rotation)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_features(params: GaussianParams, color_clip: float = float("inf")) -> torch.Tensor:
    """(CAP, K, 3) SH coefficients; only f_dc is clipped by color_clip."""
    dc = torch.clamp(params.features_dc, -color_clip, color_clip)
    return torch.cat([dc, params.features_rest], dim=1)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


def _pad_cap(arr: np.ndarray, cap: int) -> np.ndarray:
    n = arr.shape[0]
    if n > cap:
        raise ValueError(f"init point count {n} exceeds capacity {cap}")
    return np.concatenate([arr, np.zeros((cap - n,) + arr.shape[1:], arr.dtype)], 0)


def params_from_pcd(points: np.ndarray, colors: np.ndarray, cfg: GaussianFieldConfig,
                    device) -> Tuple[GaussianParams, torch.Tensor]:
    """create_from_pcd semantics: scales from log(sqrt(mean 3-NN sq dist)),
    identity rotations, constant initial opacity, colours -> SH DC."""
    cap = cfg.resolved_capacity()
    n = points.shape[0]
    k_rest = num_sh_bases(cfg.sh_degree) - 1
    pts = torch.as_tensor(points.astype(np.float32), device=device)
    dist2 = knn_ops.mean_knn_sq_dist(pts).cpu().numpy()
    dist2 = np.maximum(dist2, 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1).astype(np.float32)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opacity = np.full((n, 1), float(cfg.opacity_init), np.float32)
    opacity = np.log(opacity / (1.0 - opacity))
    f_dc = rgb_to_sh(colors.astype(np.float32)).astype(np.float32)[:, None, :]
    f_rest = np.zeros((n, k_rest, 3), np.float32)

    def dev(a):
        return torch.as_tensor(_pad_cap(a, cap), device=device)

    params = GaussianParams(
        xyz=dev(points.astype(np.float32)),
        features_dc=dev(f_dc),
        features_rest=dev(f_rest),
        scaling=dev(scales),
        rotation=dev(rots),
        opacity=dev(opacity),
        normal=dev(np.zeros((n, 3), np.float32)) if cfg.pred_normal else None,
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return params, alive


def random_sphere_pcd(cfg: GaussianFieldConfig, seed: int = 0):
    """Random-point init inside a sphere (numpy RNG, so the JAX package and
    the port draw the same points from one seed)."""
    rng = np.random.default_rng(seed)
    n = cfg.init_num_pts
    phis = rng.random(n) * 2 * np.pi
    costheta = rng.random(n) * 2 - 1
    thetas = np.arccos(costheta)
    mu = rng.random(n)
    radius = cfg.pc_init_radius * np.cbrt(mu)
    xyz = np.stack(
        [
            radius * np.sin(thetas) * np.cos(phis),
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
        ],
        axis=1,
    ).astype(np.float32)
    shs = rng.random((n, 3)).astype(np.float32) / 255.0
    colors = shs * 0.28209479177387814 + 0.5
    return xyz, colors


def state_from_params(params: GaussianParams, alive: torch.Tensor) -> GaussianState:
    cap = alive.shape[0]
    zeros = lambda: torch.zeros(cap, dtype=torch.float32, device=alive.device)  # noqa: E731
    return GaussianState(
        params=params, adam=init_adam(params.as_dict()), alive=alive,
        max_radii2d=zeros(), xyz_grad_accum=zeros(), denom=zeros(),
    )


def source_kind(cfg: GaussianFieldConfig) -> str:
    """What ``geometry_convert_from`` names: ``"prompt"`` (``shap-e:`` /
    ``lrm:``), ``"checkpoint"`` (``.ckpt(.npz)``), ``"ply"`` (every 3DGS
    attribute), ``"vertex_ply"`` (with ``load_ply_only_vertex``, the points
    of a plain cloud) or ``"sphere"`` (empty); anything else raises."""
    src = cfg.geometry_convert_from
    if src.startswith(("shap-e:", "lrm:")):
        return "prompt"
    if src.endswith((".ckpt.npz", ".ckpt")):
        return "checkpoint"
    if src.endswith(".ply"):
        return "vertex_ply" if cfg.load_ply_only_vertex else "ply"
    if src:
        raise ValueError(f"geometry_convert_from={src!r}: not a shap-e: / lrm: prompt, "
                         ".ckpt(.npz) or .ply")
    return "sphere"


# the sources that carry trained SH bands, so the field starts at the
# config's degree; the others start at 0
WARM_STARTS = ("checkpoint", "ply")


def _vertex_ply_pcd(path: str, cfg: GaussianFieldConfig, seed: int):
    """A plain point-cloud PLY (x / y / z [+ red / green / blue]) with the
    reference's hard-coded axis permutation (p @ [[0,1,0],[0,0,1],[1,0,0]]);
    its colours / 255, or with ``load_vertex_only_position`` or no colours
    the random-sphere init's colours drawn from ``seed``."""
    cols = ply_io.read_ply_table(path)
    positions = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    positions = positions @ np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
    if "red" in cols and not cfg.load_vertex_only_position:
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1).astype(np.float32)
        return positions, colors / 255.0
    shs = np.random.default_rng(seed).random((positions.shape[0], 3)).astype(np.float32) / 255.0
    return positions, shs * 0.28209479177387814 + 0.5


def _gaussian_ply_params(path: str, cfg: GaussianFieldConfig,
                         device) -> Tuple[GaussianParams, torch.Tensor]:
    """Every attribute of a 3DGS PLY, padded to the capacity."""
    raw = ply_io.load_gaussian_ply(path, cfg.sh_degree)
    cap = cfg.resolved_capacity()
    n = raw["xyz"].shape[0]

    def dev(name):
        return torch.as_tensor(_pad_cap(np.asarray(raw[name], np.float32), cap), device=device)

    params = GaussianParams(
        xyz=dev("xyz"), features_dc=dev("features_dc"), features_rest=dev("features_rest"),
        scaling=dev("scaling"), rotation=dev("rotation"), opacity=dev("opacity"),
        normal=torch.zeros((cap, 3), device=device) if cfg.pred_normal else None,
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return params, alive


def init_state(cfg: GaussianFieldConfig, seed: int = 0, device="cuda") -> GaussianState:
    """The initial field per ``geometry_convert_from``: a ``shap-e:`` /
    ``lrm:`` prompt, a port checkpoint (``.ckpt.npz``; its field with fresh
    Adam moments and zeroed statistics, at its own capacity), a PLY (every
    3DGS attribute, or with ``load_ply_only_vertex`` the points of a plain
    point cloud), or without one the random sphere."""
    src, kind = cfg.geometry_convert_from, source_kind(cfg)
    if kind == "prompt":
        # no shap-e or LRM model is ported: a sphere cloud seeded by the
        # prompt, as the JAX package draws it without those weights
        prompt = src.partition(":")[2]
        xyz, colors = random_sphere_pcd(cfg, zlib.crc32(prompt.encode("utf-8")) ^ seed)
        return state_from_params(*params_from_pcd(xyz, colors, cfg, device))
    if kind == "checkpoint":
        from ..utils.ckpt import load_checkpoint

        gauss = load_checkpoint(src, device)[0].gauss
        params = dataclasses.replace(
            gauss.params, **{k: v.clone() for k, v in gauss.params.as_dict().items()})
        return state_from_params(params, gauss.alive.clone())
    if kind in ("ply", "vertex_ply"):
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        if kind == "vertex_ply":
            return state_from_params(*params_from_pcd(*_vertex_ply_pcd(src, cfg, seed), cfg,
                                                      device))
        return state_from_params(*_gaussian_ply_params(src, cfg, device))
    xyz, colors = random_sphere_pcd(cfg, seed)
    params, alive = params_from_pcd(xyz, colors, cfg, device)
    return state_from_params(params, alive)


# ---------------------------------------------------------------------------
# Learning rates, Adam step, statistics
# ---------------------------------------------------------------------------


def lr_tree(cfg: GaussianFieldConfig, step: int) -> Dict[str, float]:
    """Per-field learning rates at `step`, exp-interpolated; f_rest runs at
    feature_lr / 20."""

    def c(v):
        return float(np.float32(C(v, 0, step, interpolation="exp")))

    feat = C(cfg.feature_lr, 0, step, interpolation="exp")
    lrs = {
        "xyz": c(cfg.position_lr),
        "features_dc": float(np.float32(feat)),
        "features_rest": float(np.float32(feat / 20.0)),
        "scaling": c(cfg.scaling_lr),
        "rotation": c(cfg.rotation_lr),
        "opacity": c(cfg.opacity_lr),
    }
    if cfg.pred_normal:
        lrs["normal"] = c(cfg.normal_lr)
    return lrs


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


@torch.no_grad()
def apply_gradients(state: GaussianState, grads: Dict[str, torch.Tensor],
                    lrs: Dict[str, float]) -> GaussianState:
    """Adam step over all parameter fields, masked to alive rows so dead
    slots never drift.  Parameters and moments are updated in place."""
    mask = state.alive
    params = state.params.as_dict()
    masked = {
        k: torch.where(_rows(mask, g), g, torch.zeros_like(g)) for k, g in grads.items()
    }
    new = adam_update(params, masked, state.adam, lrs)
    for k, p in params.items():
        p.copy_(torch.where(_rows(mask, p), new[k], p))
    return state


@torch.no_grad()
def view_stats(radii: torch.Tensor, visibility: torch.Tensor,
               vs_grad_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, CAP) per-view radii (f32), visibility and means2d gradient norms
    -> the batch's (CAP,) radii max, visible gradient-norm sum and
    visibility count, the three terms ``add_stats`` takes (and the
    data-parallel step reduces over its ranks first: max, sum, sum)."""
    grad_sum = torch.where(visibility, vs_grad_norm, torch.zeros_like(vs_grad_norm)).sum(dim=0)
    return radii.amax(dim=0), grad_sum, visibility.float().sum(dim=0)


@torch.no_grad()
def add_stats(state: GaussianState, radii_max: torch.Tensor, grad_sum: torch.Tensor,
              vis_count: torch.Tensor) -> GaussianState:
    """Fold a batch's (CAP,) ``view_stats`` into the densify statistics, in
    place."""
    state.max_radii2d.copy_(torch.maximum(state.max_radii2d, radii_max))
    state.xyz_grad_accum.add_(grad_sum)
    state.denom.add_(vis_count)
    return state


def accumulate_stats(state: GaussianState, radii: torch.Tensor,
                     visibility: torch.Tensor, vs_grad_norm: torch.Tensor) -> GaussianState:
    """radii, visibility, vs_grad_norm: (B, CAP) per view."""
    return add_stats(state, *view_stats(radii, visibility, vs_grad_norm))


# ---------------------------------------------------------------------------
# Structural ops (masked-scatter equivalents of clone / split / prune)
# ---------------------------------------------------------------------------


def _free_slot_targets(alive: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """For each row i with want[i], a distinct free slot (in ascending slot
    order, by the rank of i among the wanted rows); CAP where there is no
    free slot left or the row is not wanted, so the scatters drop it."""
    cap = alive.shape[0]
    free = torch.nonzero(~alive).squeeze(1)
    # jnp.nonzero(size=cap, fill_value=cap): fixed length, padded with cap
    free_slots = torch.full((cap,), cap, dtype=torch.long, device=alive.device)
    free_slots[: free.numel()] = free
    rank = torch.cumsum(want.long(), dim=0) - 1
    ok = want & (rank < free.numel())
    return torch.where(ok, free_slots[rank.clamp(0, cap - 1)], torch.full_like(rank, cap))


def _scatter_rows(params: GaussianParams, source: GaussianParams,
                  targets: torch.Tensor) -> GaussianParams:
    """Every field with row targets[i] set to source[i]; targets == CAP are
    dropped.  Returns new tensors in the params' own type."""
    keep = targets < targets.shape[0]
    rows = targets[keep]
    out = {}
    for k, leaf in params.as_dict().items():
        leaf = leaf.clone()
        leaf[rows] = getattr(source, k)[keep]
        out[k] = leaf
    return dataclasses.replace(params, **out)


def _reset_stats(state: GaussianState) -> GaussianState:
    """densification_postfix resets the accumulators of every row."""
    zeros = lambda: torch.zeros_like(state.max_radii2d)  # noqa: E731
    return dataclasses.replace(state, max_radii2d=zeros(), xyz_grad_accum=zeros(), denom=zeros())


@torch.no_grad()
def prune_op(state: GaussianState, min_opacity: float,
             prune_big_points: bool = False) -> GaussianState:
    """Opacity (and optionally big-point) prune; big points key off the
    mean screen radius of the alive rows."""
    mask = get_opacity(state.params)[:, 0] < min_opacity
    if prune_big_points:
        alive_f = state.alive.float()
        mean_r = torch.sum(state.max_radii2d * alive_f) / torch.clamp_min(torch.sum(alive_f), 1.0)
        mask = mask | (state.max_radii2d > mean_r * 3.0)
    return dataclasses.replace(state, alive=state.alive & ~mask)


@torch.no_grad()
def reset_opacity_op(state: GaussianState) -> GaussianState:
    """opacity <- logit(0.9 * sigmoid(opacity)); the opacity moments are
    zeroed."""
    params = dataclasses.replace(state.params,
                                 opacity=inverse_sigmoid(get_opacity(state.params) * 0.9))
    adam = zero_moments_field(clone_adam(state.adam), "opacity")
    return dataclasses.replace(state, params=params, adam=adam)


@torch.no_grad()
def sugar_prune_op(state: GaussianState, threshold: float) -> GaussianState:
    """Hard opacity prune at the SuGaR hand-off step."""
    keep = get_opacity(state.params)[:, 0] >= threshold
    return dataclasses.replace(state, alive=state.alive & keep)


@torch.no_grad()
def cap_prune_op(state: GaussianState, max_num: int,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None) -> GaussianState:
    """Random prune down to max_num alive rows.  ``draws``: (CAP,) uniform
    scores in place of the generator's."""
    cap = state.capacity
    device = state.alive.device
    scores = draws
    if scores is None:
        scores = torch.rand((cap,), generator=generator, device=generator.device)
    scores = torch.where(state.alive, scores.to(device), torch.full((cap,), -1.0, device=device))
    order = torch.argsort(-scores, stable=True)  # alive rows first, random order
    keep = torch.zeros_like(state.alive)
    keep[order[:max_num]] = True
    return dataclasses.replace(state, alive=state.alive & keep)


@torch.no_grad()
def densify_op(state: GaussianState, grad_threshold: float, split_thresh: float,
               sphere: bool = False, generator: Optional[torch.Generator] = None,
               draws: Optional[Tuple[torch.Tensor, ...]] = None) -> GaussianState:
    """Clone + split as masked scatters, in the JAX package's order: clone
    first; the split is decided on the pre-clone rows; each split parent is
    replaced in place by child 1 and child 2 takes a free slot; the
    children's scales shrink by 1 / (0.8 * 2).  A field with a
    ``trbf_center`` (the spacetime field) gives both children a new one,
    uniform in [0, 1), drawn after the two normals.  The moments are zeroed
    at the clone targets, the child-2 targets and the split parents.
    ``draws``: the two (CAP, 3) standard normals of the split children (and
    the (CAP, 1) uniforms of the trbf_center) in place of the generator's."""
    params = state.params
    cap = state.capacity
    grads = torch.where(state.denom > 0, state.xyz_grad_accum / state.denom,
                        torch.zeros_like(state.denom))
    scal = get_scaling(params, sphere)  # taken before the clone
    scale_norm = torch.linalg.norm(scal, dim=-1)

    hot = state.alive & (grads >= grad_threshold)
    clone_mask = hot & (scale_norm <= split_thresh)
    split_mask = hot & (scale_norm > split_thresh)

    # clone: copy the row into a free slot
    ctarget = _free_slot_targets(state.alive, clone_mask)
    params = _scatter_rows(params, state.params, ctarget)
    alive = state.alive | row_mask(ctarget, cap)

    # split: parent -> two resampled children, positions after the clone
    trbf = getattr(params, "trbf_center", None)
    if draws is None:
        draws = tuple(torch.randn((cap, 3), generator=generator, device=generator.device)
                      for _ in range(2))
        if trbf is not None:
            draws += (torch.rand(trbf.shape, generator=generator, device=generator.device),)
    n1, n2 = (d.to(scal.device) for d in draws[:2])
    trbf_child = None if trbf is None else draws[2].to(scal.device)
    rot = quaternion.to_rotation_matrix(params.rotation)
    child1_xyz = params.xyz + torch.einsum("nij,nj->ni", rot, n1 * scal)
    child2_xyz = params.xyz + torch.einsum("nij,nj->ni", rot, n2 * scal)
    child_scaling = torch.log(scal / (0.8 * 2))

    starget = _free_slot_targets(alive, split_mask)
    # child 2 first: it reads the parent rows before child 1 overwrites them
    child = dict(xyz=child2_xyz, scaling=child_scaling)
    if trbf_child is not None:
        child["trbf_center"] = trbf_child
    params = _scatter_rows(params, dataclasses.replace(params, **child), starget)
    alive = alive | row_mask(starget, cap)
    smask = split_mask[:, None]
    child["xyz"] = child1_xyz
    params = dataclasses.replace(
        params, **{k: torch.where(smask, v, getattr(params, k)) for k, v in child.items()})
    # the new rows (clone targets, child-2 targets) and the split parents
    adam = zero_moments_where(clone_adam(state.adam), (alive & ~state.alive) | split_mask)
    return _reset_stats(dataclasses.replace(state, params=params, alive=alive, adam=adam))


@register("gaussian-splatting")
class GaussianField:
    """Host-side wrapper: owns the config and schedules; all device state
    lives in a `GaussianState`."""

    Config = GaussianFieldConfig

    def __init__(self, cfg: Optional[GaussianFieldConfig] = None, device="cuda", **kwargs):
        if cfg is None:
            cfg = self.Config(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(self.Config, cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.active_sh_degree = cfg.sh_degree if source_kind(cfg) in WARM_STARTS else 0

    def init_state(self, seed: int = 0) -> GaussianState:
        return init_state(self.cfg, seed, self.device)

    def lr_tree(self, step: int) -> Dict[str, float]:
        return lr_tree(self.cfg, step)

    def color_clip(self, step: int) -> float:
        return float(C(self.cfg.color_clip, 0, step))

    def apply_gradients(self, state: GaussianState, grads: Dict[str, torch.Tensor],
                        lrs: Dict[str, float]) -> GaussianState:
        return apply_gradients(state, grads, lrs)

    def accumulate_stats(self, state: GaussianState, radii: torch.Tensor,
                         visibility: torch.Tensor, vs_grad_norm: torch.Tensor) -> GaussianState:
        return accumulate_stats(state, radii, visibility, vs_grad_norm)

    def add_stats(self, state: GaussianState, radii_max: torch.Tensor, grad_sum: torch.Tensor,
                  vis_count: torch.Tensor) -> GaussianState:
        return add_stats(state, radii_max, grad_sum, vis_count)

    def update_states(self, state: GaussianState, iteration: int,
                      generator: Optional[torch.Generator] = None,
                      draws=None) -> Tuple[GaussianState, bool]:
        """Interval-gated adaptive density control; returns (state, changed).
        The JAX package's order: the SuGaR prune alone at its step; at a
        prune or densify step over the budget (n_alive >= max_num + 100) the
        cap-prune alone; else prune (then the opacity reset when due), then
        densify.  ``draws`` (tests only) goes to the cap-prune or densify
        that runs."""
        cfg = self.cfg
        if cfg.sugar_prune_at is not None and iteration == cfg.sugar_prune_at:
            return sugar_prune_op(state, float(np.float32(cfg.sugar_prune_threshold))), True
        prune_step = (
            cfg.prune_from_iter < iteration < cfg.prune_until_iter
            and iteration % cfg.prune_interval == 0
        )
        densify_step = (
            cfg.densify_from_iter < iteration < cfg.densify_until_iter
            and iteration % cfg.densification_interval == 0
        )
        if (prune_step or densify_step) and state.n_alive >= cfg.max_num + 100:
            return cap_prune_op(state, cfg.max_num, generator, draws), True
        changed = False
        if prune_step:
            min_opac = float(np.float32(C(cfg.min_opac_prune, 0, iteration)))
            state = prune_op(state, min_opac, prune_big_points=cfg.prune_big_points)
            if iteration % cfg.opacity_reset_interval == 0:
                state = reset_opacity_op(state)
            changed = True
        if densify_step:
            state = densify_op(
                state,
                float(np.float32(C(cfg.densify_grad_threshold, 0, iteration))),
                float(np.float32(C(cfg.split_thresh, 0, iteration))),
                sphere=cfg.sphere, generator=generator, draws=draws,
            )
            changed = True
        return state, changed

    def save_ply(self, state: GaussianState, path: str) -> None:
        """The alive rows as a 3DGS PLY (byte-compatible with the JAX
        package's)."""
        alive = state.alive.cpu().numpy()
        host = {k: v.detach().cpu().numpy()[alive] for k, v in state.params.as_dict().items()}
        ply_io.save_gaussian_ply(
            path, xyz=host["xyz"], features_dc=host["features_dc"],
            features_rest=host["features_rest"], opacity=host["opacity"],
            scaling=host["scaling"], rotation=host["rotation"],
        )
