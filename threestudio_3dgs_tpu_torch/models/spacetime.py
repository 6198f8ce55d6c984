"""Spacetime (4D) Gaussian field (port of the JAX package's
``models/spacetime.py``, ``spacetime-gaussian-splatting``).

Four motion modes, composable as in the JAX package:
  * polynomial: per-point ``motion`` (rank-3 polynomial in dt) and
    ``omega`` (rank-1 quaternion rate), dt = t - trbf_center with no
    gradient (the TRBF opacity modulation stays off, as there);
  * per-frame deltas: ``delta_xyz`` (CAP, T, 3) / ``delta_rot`` (CAP, T, 4)
    indexed by the frame;
  * the HexPlane deformation network (``models/deformation.py``, its
    parameters in the system's extra parameters);
  * the SE(3) cubic B-spline: control knots from the motion above at the
    frame times, recomputed in the graph, so they stay differentiable.

Colours are SH2RGB(f_dc), a quirk of the reference kept by the JAX
package: the spacetime renderer passes precomputed colours.  The
structural ops are the static field's (generic over the params type; the
split children draw a new ``trbf_center``).  The temporal PLY carries the
temporal attributes as vertex properties in the reference's order."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import quaternion, spline
from ..ops.sh import sh_to_rgb
from ..utils.config import C
from ..utils.registry import register
from . import gaussian_field as gf
from . import ply_io
from .deformation import DeformationConfig, deformation_apply, init_deformation_params

TEMPORAL_FIELDS = ("motion", "omega", "trbf_center", "trbf_scale", "delta_xyz", "delta_rot")


@dataclasses.dataclass
class SpacetimeParams(gf.GaussianParams):
    FIELDS = gf.PARAM_FIELDS + TEMPORAL_FIELDS

    motion: Optional[torch.Tensor] = None  # (CAP, 3 * rank_motion)
    omega: Optional[torch.Tensor] = None  # (CAP, 4 * rank_omega)
    trbf_center: Optional[torch.Tensor] = None  # (CAP, 1)
    trbf_scale: Optional[torch.Tensor] = None  # (CAP, 1)
    delta_xyz: Optional[torch.Tensor] = None  # (CAP, T, 3)
    delta_rot: Optional[torch.Tensor] = None  # (CAP, T, 4)


@dataclasses.dataclass
class SpacetimeConfig(gf.GaussianFieldConfig):
    num_frames: int = 14
    use_spline: bool = False
    enable_static: bool = False
    enable_dynamic: bool = False
    delta_xyz_lr: Any = 0.001
    delta_rot_lr: Any = 0.0001
    enable_spacetime: bool = True
    omega_lr: Any = 0.01
    trbfc_lr: Any = 0.01
    trbfs_lr: Any = 0.01
    move_lr: Any = 0.01
    rank_motion: int = 3
    rank_omega: int = 1
    addsphpointsscale: float = 0.8
    trbfslinit: float = 0.1
    raystart: float = 0.7
    spatial_lr_scale: float = 10.0
    enable_deformation: bool = False
    deformation_lr: Any = 0
    grid_lr: Any = 0


# ---------------------------------------------------------------------------
# Timed evaluation
# ---------------------------------------------------------------------------


def _frame(table: torch.Tensor, frame_idx) -> torch.Tensor:
    if frame_idx is None:
        raise ValueError("per-frame dynamic mode needs frame_idx")
    return table[:, int(frame_idx)]


def get_motion(params: SpacetimeParams, cfg, delta_t, frame_idx) -> torch.Tensor:
    """Polynomial + per-frame translation offset."""
    motion = torch.zeros_like(params.xyz)
    if cfg.enable_spacetime and params.motion is not None:
        m = params.motion.reshape(-1, cfg.rank_motion, 3)
        for i in range(cfg.rank_motion):
            motion = motion + m[:, i, :] * delta_t ** (i + 1)
    if cfg.enable_dynamic and params.delta_xyz is not None:
        motion = motion + _frame(params.delta_xyz, frame_idx)
    return motion


def get_omega(params: SpacetimeParams, cfg, delta_t, frame_idx) -> torch.Tensor:
    """Raw quaternion offset."""
    omega = torch.zeros_like(params.rotation)
    if cfg.enable_spacetime and params.omega is not None:
        o = params.omega.reshape(-1, cfg.rank_omega, 4)
        for i in range(cfg.rank_omega):
            omega = omega + o[:, i, :] * delta_t ** (i + 1)
    if cfg.enable_dynamic and params.delta_rot is not None:
        omega = omega + _frame(params.delta_rot, frame_idx)
    return omega


def _timed_xyz_rot_raw(params: SpacetimeParams, cfg: SpacetimeConfig, timestamp, frame_idx,
                       deformation_params=None, deformation_cfg=None):
    """Raw (pre-activation) timed means, rotations, scales and opacities."""
    xyz, rotation = params.xyz, params.rotation
    scaling, opacity = params.scaling, params.opacity
    n = xyz.shape[0]
    ts = torch.as_tensor(timestamp, dtype=torch.float32, device=xyz.device).reshape(()).expand(n)
    if cfg.enable_deformation and deformation_params is not None:
        xyz, scaling, rotation, opacity = deformation_apply(
            deformation_params, deformation_cfg, xyz, scaling, rotation, opacity, ts * 2.0 - 1.0)
    if cfg.enable_spacetime and params.trbf_center is not None:
        delta_t = (ts[:, None] - params.trbf_center).detach()
    else:
        delta_t = torch.zeros((n, 1), device=xyz.device)
    rotation = rotation + get_omega(params, cfg, delta_t, frame_idx)
    xyz = xyz + get_motion(params, cfg, delta_t, frame_idx)
    return xyz, rotation, scaling, opacity


def compute_control_knots(params: SpacetimeParams, cfg: SpacetimeConfig,
                          deformation_params=None, deformation_cfg=None):
    """Per-point SE(3) knots (N, K, 3) and (N, K, 4): knot k is the motion
    state of frame k at spline time linspace(start, end, K)[k]."""
    k = cfg.num_frames
    interval, start, _, _ = spline.spline_timing(k, degree=3)
    times = np.linspace(start, start + (k - 1) * interval, k)
    knots_xyz, knots_rot = [], []
    for i, t in enumerate(times):
        xyz, rot, _, _ = _timed_xyz_rot_raw(params, cfg, np.float32(t), i, deformation_params,
                                            deformation_cfg)
        knots_xyz.append(xyz)
        knots_rot.append(quaternion.normalize(rot))
    return torch.stack(knots_xyz, dim=1), torch.stack(knots_rot, dim=1)


def get_timed_all(params: SpacetimeParams, cfg: SpacetimeConfig, timestamp, frame_idx=None,
                  deformation_params=None, deformation_cfg=None, knots=None):
    """(means3D, scales, rotations, opacity, colours), activated, at
    ``timestamp``.  ``knots`` (spline mode): the ``compute_control_knots``
    of these params, computed once for a batch of views; they do not
    depend on the timestamp."""
    if cfg.use_spline:
        if knots is None:
            knots = compute_control_knots(params, cfg, deformation_params, deformation_cfg)
        xyz, rot = spline.spline_eval(knots[0], knots[1], timestamp)
        scaling, opacity = params.scaling, params.opacity
    else:
        xyz, rot, scaling, opacity = _timed_xyz_rot_raw(params, cfg, timestamp, frame_idx,
                                                        deformation_params, deformation_cfg)
    colors = sh_to_rgb(params.features_dc[:, 0, :])
    return xyz, torch.exp(scaling), quaternion.normalize(rot), torch.sigmoid(opacity), colors


# ---------------------------------------------------------------------------
# The field
# ---------------------------------------------------------------------------


@register("spacetime-gaussian-splatting")
class SpacetimeGaussianField(gf.GaussianField):
    Config = SpacetimeConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        super().__init__(cfg, device, **kwargs)
        self.deformation_cfg = DeformationConfig() if self.cfg.enable_deformation else None

    def init_state(self, seed: int = 0) -> gf.GaussianState:
        """The static field's init with zero motion, omega, trbf_center and
        per-frame deltas and trbf_scale at ``trbfslinit``; a checkpoint
        that carries temporal fields keeps them."""
        base = super().init_state(seed)
        p = base.params
        if isinstance(p, SpacetimeParams) and (p.motion is not None or p.delta_xyz is not None):
            return base
        cfg, cap, dev = self.cfg, p.xyz.shape[0], p.xyz.device

        def zeros(*shape):
            return torch.zeros((cap,) + shape, device=dev)

        spacetime, dynamic = cfg.enable_spacetime, cfg.enable_dynamic
        st = SpacetimeParams(
            **p.as_dict(),
            motion=zeros(3 * cfg.rank_motion) if spacetime else None,
            omega=zeros(4 * cfg.rank_omega) if spacetime else None,
            trbf_center=zeros(1) if spacetime else None,
            trbf_scale=torch.full((cap, 1), cfg.trbfslinit, device=dev) if spacetime else None,
            delta_xyz=zeros(cfg.num_frames, 3) if dynamic else None,
            delta_rot=zeros(cfg.num_frames, 4) if dynamic else None,
        )
        return gf.state_from_params(st, base.alive)

    def init_deformation(self, generator: torch.Generator) -> Optional[Dict[str, torch.Tensor]]:
        if not self.cfg.enable_deformation:
            return None
        return init_deformation_params(self.deformation_cfg, generator, self.device)

    def lr_tree(self, step: int) -> Dict[str, float]:
        cfg = self.cfg
        lrs = super().lr_tree(step)
        lrs["xyz"] = float(np.float32(lrs["xyz"]) * np.float32(cfg.spatial_lr_scale))

        def c(v):
            return float(np.float32(C(v, 0, step, interpolation="exp")))

        if cfg.enable_spacetime:
            lrs.update(motion=c(cfg.move_lr), omega=c(cfg.omega_lr),
                       trbf_center=c(cfg.trbfc_lr), trbf_scale=c(cfg.trbfs_lr))
        if cfg.enable_dynamic:
            lrs.update(delta_xyz=c(cfg.delta_xyz_lr), delta_rot=c(cfg.delta_rot_lr))
        return lrs

    def control_knots(self, gauss: gf.GaussianState, deformation_params=None):
        """The spline's knots of ``gauss`` (None outside spline mode)."""
        if not self.cfg.use_spline:
            return None
        return compute_control_knots(gauss.params, self.cfg, deformation_params,
                                     self.deformation_cfg)

    def get_timed_all(self, gauss, timestamp, frame_idx=None, deformation_params=None,
                      knots=None):
        return get_timed_all(gauss.params, self.cfg, timestamp, frame_idx, deformation_params,
                             self.deformation_cfg, knots)

    # -- the temporal PLY -----------------------------------------------------
    def temporal_columns(self, state: gf.GaussianState) -> Dict[str, np.ndarray]:
        """The temporal attributes of the alive rows as named columns, in
        the reference's order: delta_{x,y,z}_t{i}, then delta_rot_{j}_t{i},
        trbf_center, trbf_scale, motion_{i}, omega_{i}."""
        alive = state.alive.cpu().numpy()
        p = state.params

        def host(t):
            return t.detach().cpu().numpy()[alive]

        cols: Dict[str, np.ndarray] = {}
        if p.delta_xyz is not None:
            d, r = host(p.delta_xyz), host(p.delta_rot)
            for t in range(d.shape[1]):
                for j, ax in enumerate("xyz"):
                    cols[f"delta_{ax}_t{t}"] = d[:, t, j]
            for t in range(r.shape[1]):
                for j in range(4):
                    cols[f"delta_rot_{j}_t{t}"] = r[:, t, j]
        if p.trbf_center is not None:
            cols["trbf_center"] = host(p.trbf_center)[:, 0]
            cols["trbf_scale"] = host(p.trbf_scale)[:, 0]
        for name in ("motion", "omega"):
            if getattr(p, name) is not None:
                m = host(getattr(p, name))
                for i in range(m.shape[1]):
                    cols[f"{name}_{i}"] = m[:, i]
        return cols

    def save_ply(self, state: gf.GaussianState, path: str, sidecar: bool = False) -> None:
        """The 3DGS attributes (f_rest kept, unlike the reference's writer)
        and then the temporal columns as vertex properties; ``sidecar``
        also writes them to ``path + ".temporal.npz"``."""
        alive = state.alive.cpu().numpy()
        host = {k: v.detach().cpu().numpy()[alive] for k, v in state.params.as_dict().items()}
        cols = self.temporal_columns(state)
        ply_io.save_gaussian_ply(
            path, xyz=host["xyz"], features_dc=host["features_dc"],
            features_rest=host["features_rest"], opacity=host["opacity"],
            scaling=host["scaling"], rotation=host["rotation"], extra=cols,
        )
        if sidecar and cols:
            np.savez(path + ".temporal.npz", **cols)

    @staticmethod
    def load_temporal_ply(path: str) -> Dict[str, np.ndarray]:
        """The temporal columns of a PLY stacked back into arrays: motion
        (N, 3R), omega (N, 4R), trbf_center / trbf_scale (N, 1), delta_xyz
        (N, T, 3), delta_rot (N, T, 4); those the file lacks are left out."""
        cols = ply_io.read_ply_table(path)
        out: Dict[str, np.ndarray] = {}

        def stack(names):
            return np.stack([cols[k].astype(np.float32) for k in names], axis=1)

        for name in ("motion", "omega"):
            names = sorted((k for k in cols if k.startswith(f"{name}_")),
                           key=lambda s: int(s.split("_")[-1]))
            if names:
                out[name] = stack(names)
        if "trbf_center" in cols:
            out["trbf_center"] = cols["trbf_center"].astype(np.float32)[:, None]
            out["trbf_scale"] = cols["trbf_scale"].astype(np.float32)[:, None]
        n_frames = len([k for k in cols if k.startswith("delta_x_t")])
        if n_frames:
            out["delta_xyz"] = np.stack(
                [stack([f"delta_{ax}_t{t}" for ax in "xyz"]) for t in range(n_frames)], axis=1)
            out["delta_rot"] = np.stack(
                [stack([f"delta_rot_{j}_t{t}" for j in range(4)]) for t in range(n_frames)],
                axis=1)
        return out

    @staticmethod
    def load_extra(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
