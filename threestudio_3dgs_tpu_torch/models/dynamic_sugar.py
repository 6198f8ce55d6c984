"""Dynamic SuGaR: mesh-bound Gaussians that move over time (port of the JAX
package's ``models/dynamic_sugar.py``, geometry ``dynamic-sugar``).

The motion model is a deformation graph of M nodes drawn from the mesh
vertices (``np.random.default_rng(seed).choice``, as in the JAX package).
Each node has a track of per-frame translations and rotations (mode
"discrete"), evaluated at a time by a cubic SE(3) B-spline over the frame
axis (``use_spline``) or read at the frame index.  Vertices follow the
nodes through linear-blend (``lbs``) or dual-quaternion (``dqs``) skinning,
with inverse-distance weights over each vertex's k nearest nodes: k-NN in
Euclidean space, or heat-method geodesics (``dg_dist_mode: geodesic``,
``models/geodesic.py``).  In mode "deformation" the vertices move by the
HexPlane network's position deltas instead (``extra_params["deformation"]``
of the system, default ``DeformationConfig()``).  Per-node log-scale
(``d_scale``) and opacity (``d_opacity``) delta tracks are skinned to the
vertices and blended barycentrically onto the Gaussians.  With
``use_deform_graph: false`` every vertex is its own node with weight 1.
``as_gaussian_arrays`` (inherited) gives the canonical mesh's Gaussians,
``get_timed_gs_arrays`` those at a time.

As in the JAX package (its design note), the timed Gaussians' rotations
come from the face frames of the deformed mesh, composed with the learned
in-plane rotation."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import dual_quaternion as dq
from ..ops import knn as knn_ops
from ..ops import quaternion, spline
from ..utils.config import C
from ..utils.registry import register
from .deformation import DeformationConfig, deformation_xyz_rotation
from .optim import init_adam
from .sugar import SuGaRConfig, SuGaRModel, SuGaRParams, SuGaRState

NODE_FIELDS = ("node_trans", "node_rots", "node_scales", "node_opacity")
GRAPH_FIELDS = ("nodes_xyz", "skin_idx", "skin_w")


@dataclasses.dataclass
class DynamicSuGaRParams(SuGaRParams):
    FIELDS = SuGaRParams.FIELDS + NODE_FIELDS

    node_trans: Optional[torch.Tensor] = None  # (M, T, 3)
    node_rots: Optional[torch.Tensor] = None  # (M, T, 4) raw wxyz
    node_scales: Optional[torch.Tensor] = None  # (M, T, 3) log-scale deltas (d_scale)
    node_opacity: Optional[torch.Tensor] = None  # (M, T, 1) logit deltas (d_opacity)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS if getattr(self, k) is not None}


@dataclasses.dataclass
class DynamicSuGaRState(SuGaRState):
    nodes_xyz: Optional[torch.Tensor] = None  # (M, 3) rest node positions
    skin_idx: Optional[torch.Tensor] = None  # (V, K) int64 node of each vertex
    skin_w: Optional[torch.Tensor] = None  # (V, K) normalised weights


@dataclasses.dataclass
class DynamicSuGaRConfig(SuGaRConfig):
    num_frames: int = 14
    n_dg_nodes: int = 1000
    dg_node_connectivity: int = 8
    dynamic_mode: str = "discrete"  # "discrete" | "deformation"
    skinning_method: str = "lbs"  # "lbs" | "dqs"
    dg_dist_mode: str = "euclidean"  # "euclidean" | "geodesic"
    use_spline: bool = True
    use_deform_graph: bool = True
    d_scale: bool = True
    d_opacity: bool = False
    d_xyz_lr: Any = 0.001
    d_rot_lr: Any = 0.0001
    d_scale_lr: Any = 0.001
    d_opacity_lr: Any = 0.001


def skinning_weights(verts: torch.Tensor, nodes: torch.Tensor, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse-distance weights over each vertex's k nearest nodes
    (Euclidean), normalised: ((V, k) int32 indices, (V, k) f32 weights),
    on the host."""
    d2, idx = knn_ops.knn(verts, nodes, k=k)
    d2 = d2.cpu().numpy()
    w = 1.0 / np.maximum(np.sqrt(d2), 1e-6)
    w = w / w.sum(axis=1, keepdims=True)
    return idx.cpu().numpy().astype(np.int32), w.astype(np.float32)


def skinning_weights_geodesic(verts: np.ndarray, faces: np.ndarray, node_ids: np.ndarray,
                              k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse geodesic-distance weights over each vertex's k geodesically
    nearest nodes (the heat method, on the host)."""
    from .geodesic import heat_geodesic_distances

    dists = heat_geodesic_distances(verts, faces, np.asarray(node_ids, np.int32)).T  # (V, M)
    idx = np.argsort(dists, axis=1)[:, :k].astype(np.int32)
    d = np.take_along_axis(dists, idx, axis=1)
    w = 1.0 / np.maximum(d, 1e-6)
    w = w / w.sum(axis=1, keepdims=True)
    return idx, w.astype(np.float32)


def node_transforms_at(params: DynamicSuGaRParams, cfg: DynamicSuGaRConfig, timestamp,
                       frame_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(translations (M, 3), unit quaternions (M, 4)) of the nodes at a
    time: the spline over the frame knots, or the frame's knot."""
    quat_knots = quaternion.normalize(params.node_rots)
    if cfg.use_spline:
        return spline.spline_eval(params.node_trans, quat_knots, timestamp, degree=3)
    f = int(frame_idx)
    return params.node_trans[:, f], quat_knots[:, f]


def node_deltas_at(knots: Optional[torch.Tensor], cfg: DynamicSuGaRConfig, timestamp,
                   frame_idx) -> Optional[torch.Tensor]:
    """(M, C) vector deltas of the nodes at a time, splined with the
    translations' basis, or the frame's knot; None without a track."""
    if knots is None:
        return None
    if cfg.use_spline:
        return spline.spline_eval_vec(knots, timestamp, degree=3)
    return knots[:, int(frame_idx)]


def node_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` through ``index_select``, whose backward adds with
    atomics: advanced indexing's backward sorts the indices and walks each
    index's duplicates serially on the card, and a node is gathered by
    about V K / M skin entries (~3,800 at 236k vertices, k 16, 1000
    nodes)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def skin_vector_attrs(node_vals: torch.Tensor, skin_idx: torch.Tensor,
                      skin_w: torch.Tensor) -> torch.Tensor:
    """(V, C): the skinning-weighted blend of per-node values."""
    return torch.sum(skin_w[..., None] * node_rows(node_vals, skin_idx), dim=1)


def gaussian_vertex_blend(vert_vals: torch.Tensor, faces: torch.Tensor,
                          bary: torch.Tensor) -> torch.Tensor:
    """(F * G, C): per-vertex values blended barycentrically onto the
    Gaussians of every face."""
    fv = vert_vals[faces]  # (F, 3, C)
    return torch.einsum("gk,fkc->fgc", bary, fv).reshape(-1, fv.shape[-1])


def skin_vertices(verts: torch.Tensor, nodes: torch.Tensor, node_t: torch.Tensor,
                  node_q: torch.Tensor, skin_idx: torch.Tensor, skin_w: torch.Tensor,
                  method: str = "lbs") -> torch.Tensor:
    """The vertices moved by their nodes' rigid transforms about the node
    centres, blended linearly (``lbs``) or as dual quaternions (``dqs``)."""
    nk, qk, tk = (node_rows(x, skin_idx) for x in (nodes, node_q, node_t))  # (V, K, .)
    if method == "lbs":
        moved = quaternion.apply(qk, verts[:, None, :] - nk) + nk + tk
        return torch.sum(skin_w[..., None] * moved, dim=1)
    if method == "dqs":
        # about the node centre: R p + (n + t - R n)
        t_eff = nk + tk - quaternion.apply(qk, nk)
        blended = dq.blend(dq.from_quat_translation(qk, t_eff), skin_w)
        return dq.transform_point(blended, verts)
    raise ValueError(f"unknown skinning_method {method!r}")


@register("dynamic-sugar")
class DynamicSuGaRModel(SuGaRModel):
    Config = DynamicSuGaRConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        super().__init__(cfg, device, **kwargs)
        self.deformation_cfg = DeformationConfig()

    def init_state(self, seed: int = 0) -> DynamicSuGaRState:
        """The bound mesh's Gaussians (``SuGaRModel.init_state``), the
        deformation graph and its skinning tables, and zero tracks
        (identity rotations) over ``num_frames`` knots."""
        base = super().init_state(seed)
        cfg: DynamicSuGaRConfig = self.cfg
        points = base.params.points
        verts = points.cpu().numpy()
        rng = np.random.default_rng(seed)
        if cfg.use_deform_graph:
            m = min(cfg.n_dg_nodes, len(verts))
            node_ids = rng.choice(len(verts), size=m, replace=False)
            nodes = verts[node_ids]
            k = min(cfg.dg_node_connectivity, m)
            if cfg.dg_dist_mode == "geodesic":
                skin_idx, skin_w = skinning_weights_geodesic(verts, base.faces.cpu().numpy(),
                                                             node_ids, k)
            else:
                skin_idx, skin_w = skinning_weights(
                    points, torch.as_tensor(nodes, device=self.device), k)
        else:
            m = len(verts)
            nodes = verts
            skin_idx = np.arange(m, dtype=np.int32)[:, None]
            skin_w = np.ones((m, 1), np.float32)

        t = cfg.num_frames

        def zeros(*shape):
            return torch.zeros(shape, device=self.device)

        rots0 = zeros(m, t, 4)
        rots0[..., 0] = 1.0
        params = DynamicSuGaRParams(
            **base.params.as_dict(),
            node_trans=zeros(m, t, 3), node_rots=rots0,
            node_scales=zeros(m, t, 3) if cfg.d_scale else None,
            node_opacity=zeros(m, t, 1) if cfg.d_opacity else None,
        )
        return DynamicSuGaRState(
            params=params, adam=init_adam(params.as_dict()), faces=base.faces, bary=base.bary,
            thickness=base.thickness,
            nodes_xyz=torch.as_tensor(nodes, dtype=torch.float32, device=self.device),
            skin_idx=torch.as_tensor(skin_idx, dtype=torch.int64, device=self.device),
            skin_w=torch.as_tensor(skin_w, dtype=torch.float32, device=self.device),
        )

    def lr_tree(self, step: int) -> Dict[str, float]:
        cfg: DynamicSuGaRConfig = self.cfg
        lrs = super().lr_tree(step)

        def c(v):
            return float(np.float32(C(v, 0, step, interpolation="exp")))

        lrs.update(node_trans=c(cfg.d_xyz_lr), node_rots=c(cfg.d_rot_lr))
        if cfg.d_scale:
            lrs["node_scales"] = c(cfg.d_scale_lr)
        if cfg.d_opacity:
            lrs["node_opacity"] = c(cfg.d_opacity_lr)
        return lrs

    # -- timed evaluation ------------------------------------------------------
    def timed_vertices(self, state: DynamicSuGaRState, timestamp, frame_idx,
                       deformation_params=None) -> torch.Tensor:
        """(V, 3): the mesh at a time, moved by the deformation network (mode
        "deformation" with its parameters) or skinned to the nodes."""
        cfg: DynamicSuGaRConfig = self.cfg
        points = state.params.points
        if cfg.dynamic_mode == "deformation" and deformation_params is not None:
            n = points.shape[0]
            ts = torch.as_tensor(timestamp, dtype=torch.float32, device=points.device).expand(n)

            def position_deltas(params, xyz, t):
                return deformation_xyz_rotation(params, self.deformation_cfg, xyz,
                                                torch.zeros((n, 4), device=xyz.device), t)[0]

            # the network's plane samples hold ~6 (32, V) tensors a plane for
            # the backward (~6 GB a call at 236k vertices, once per view):
            # under autograd it keeps its inputs alone and is run again in
            # the backward, which computes the same gradients
            if torch.is_grad_enabled():
                dx = torch.utils.checkpoint.checkpoint(position_deltas, deformation_params,
                                                       points, ts * 2.0 - 1.0,
                                                       use_reentrant=False)
            else:
                dx = position_deltas(deformation_params, points, ts * 2.0 - 1.0)
            return points + dx
        node_t, node_q = node_transforms_at(state.params, cfg, timestamp, frame_idx)
        return skin_vertices(points, state.nodes_xyz, node_t, node_q, state.skin_idx,
                             state.skin_w, cfg.skinning_method)

    def get_timed_gs_arrays(self, state: DynamicSuGaRState, timestamp, frame_idx,
                            deformation_params=None, color_clip: float = float("inf")
                            ) -> Dict[str, torch.Tensor]:
        """The rasterizer's arrays at a time: positions and face frames from
        the timed mesh; the node scale deltas (components 1:3, the tangent
        scales) and opacity deltas skinned, blended onto the Gaussians and
        added before the activations; SH shared with the canonical
        params."""
        cfg: DynamicSuGaRConfig = self.cfg
        p = state.params
        verts_t = self.timed_vertices(state, timestamp, frame_idx, deformation_params)
        scales_raw, densities = p.scales, p.densities
        if p.node_scales is not None:
            nd = node_deltas_at(p.node_scales, cfg, timestamp, frame_idx)
            gd = gaussian_vertex_blend(skin_vector_attrs(nd, state.skin_idx, state.skin_w),
                                       state.faces, state.bary)
            scales_raw = scales_raw + gd[:, 1:3]
        if p.node_opacity is not None:
            nd = node_deltas_at(p.node_opacity, cfg, timestamp, frame_idx)
            densities = densities + gaussian_vertex_blend(
                skin_vector_attrs(nd, state.skin_idx, state.skin_w), state.faces, state.bary)
        timed = SuGaRParams(points=verts_t, sh_dc=p.sh_dc, sh_rest=p.sh_rest, scales=scales_raw,
                            complex_rot=p.complex_rot, densities=densities)
        return self.as_gaussian_arrays(dataclasses.replace(state, params=timed), color_clip)
