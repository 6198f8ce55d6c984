"""SuGaR: Gaussians bound to a surface mesh (port of the JAX package's
``models/sugar.py``, geometry ``sugar``).

The representation after the SuGaR handoff: learnable mesh vertices,
``n_gaussians_per_surface_triangle`` Gaussians at fixed barycentric
coordinates inside every face (``BARY_TABLES``: 1, 3, 4 or 6 a face),
flat Gaussians with two learned tangent scales and a constant thickness
along the face normal, rotations = the face frame composed with a learned
in-plane rotation (cos, sin), SH colour coefficients and per-Gaussian
opacity logits.

``SuGaRParams`` holds the learnables; the faces, the barycentric table and
the thickness are fixed buffers of ``SuGaRState``, and the topology of the
smoothness losses lives on the host wrapper (``topology`` in numpy, and
``topology_t``, its tables moved to the device once at binding).  Adam
steps every param (no row is dead); the Gaussians are never densified.
The getters are torch functions of the params, so a render differentiates
into the mesh vertices.  Before ``--predict``'s texture bake,
``postprocess_state`` peels the mesh's low-density border faces
(``compute_density``: the 16 nearest Gaussians' anisotropic density at the
removed faces' centres)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import mesh as mesh_ops
from ..ops import quaternion
from ..ops.gaussian_math import inverse_sigmoid
from ..ops.sh import num_sh_bases, rgb_to_sh
from ..utils.config import C, parse_structured
from ..utils.registry import register
from .optim import AdamState, adam_update, init_adam

BARY_TABLES = {
    1: (np.array([[1 / 3, 1 / 3, 1 / 3]], np.float32), 1.0 / 2.0 / np.sqrt(3.0)),
    3: (
        np.array([[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
                 np.float32),
        1.0 / 2.0 / (np.sqrt(3.0) + 1.0),
    ),
    4: (
        np.array([[1 / 3, 1 / 3, 1 / 3], [2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                  [1 / 6, 1 / 6, 2 / 3]], np.float32),
        1.0 / (4.0 * np.sqrt(3.0)),
    ),
    6: (
        np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
                  [1 / 6, 5 / 12, 5 / 12], [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6]],
                 np.float32),
        1.0 / (4.0 + 2.0 * np.sqrt(3.0)),
    ),
}


@dataclasses.dataclass
class SuGaRParams:
    FIELDS = ("points", "sh_dc", "sh_rest", "scales", "complex_rot", "densities")

    points: torch.Tensor  # (V, 3) mesh vertices
    sh_dc: torch.Tensor  # (Ng, 1, 3)
    sh_rest: torch.Tensor  # (Ng, K-1, 3)
    scales: torch.Tensor  # (Ng, 2) log tangent scales
    complex_rot: torch.Tensor  # (Ng, 2) in-plane rotation (cos, sin)
    densities: torch.Tensor  # (Ng, 1) opacity logits

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS}


@dataclasses.dataclass
class SuGaRState:
    params: SuGaRParams
    adam: AdamState
    faces: torch.Tensor  # (F, 3) int64, fixed topology
    bary: torch.Tensor  # (G, 3) barycentric table
    thickness: torch.Tensor  # () constant normal thickness

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def n_gaussians(self) -> int:
        return self.faces.shape[0] * self.bary.shape[0]


@dataclasses.dataclass
class SuGaRConfig:
    """Mirrors the JAX package's SuGaRConfig."""

    sh_levels: int = 1
    position_lr: Any = 0.001
    feature_lr: Any = 0.01
    opacity_lr: Any = 0.05
    scaling_lr: Any = 0.005
    rotation_lr: Any = 0.005
    triangle_scale: float = 1.0
    n_gaussians_per_surface_triangle: int = 1
    keep_track_of_knn: bool = False
    knn_to_track: int = 16
    beta_mode: str = "average"
    primitive_types: str = "diamond"
    surface_mesh_to_bind_path: str = ""
    learn_surface_mesh_positions: bool = True
    learn_surface_mesh_opacity: bool = True
    learn_surface_mesh_scales: bool = True
    freeze_gaussians: bool = False
    spatial_lr_scale: float = 10.0
    spatial_extent: float = 3.5
    color_clip: Any = 2.0
    gs_color_inherit_vertices: bool = True
    init_gs_opacity: float = 0.5
    geometry_convert_from: str = ""
    square_size_in_texture: int = 10
    pred_normal: bool = False


# ---------------------------------------------------------------------------
# Getters
# ---------------------------------------------------------------------------


def gaussian_positions(params: SuGaRParams, faces: torch.Tensor, bary: torch.Tensor
                       ) -> torch.Tensor:
    """(Ng, 3): the barycentric points inside every face."""
    faces_verts = params.points[faces.long()]  # (F, 3, 3)
    return torch.einsum("gk,fkc->fgc", bary, faces_verts).reshape(-1, 3)


def face_frames(params: SuGaRParams, faces: torch.Tensor):
    """(normals, base_r1, base_r2) per face: the unit normal, the first
    edge direction, and their cross product."""
    fn = mesh_ops.face_normals(params.points, faces)
    faces_verts = params.points[faces.long()]
    r1 = faces_verts[:, 0] - faces_verts[:, 1]
    r1 = r1 / torch.clamp_min(torch.linalg.norm(r1, dim=-1, keepdim=True), 1e-12)
    r2 = torch.linalg.cross(fn, r1, dim=-1)
    r2 = r2 / torch.clamp_min(torch.linalg.norm(r2, dim=-1, keepdim=True), 1e-12)
    return fn, r1, r2


def gaussian_quaternions(params: SuGaRParams, faces: torch.Tensor, n_per_face: int
                         ) -> torch.Tensor:
    """(Ng, 4) wxyz: the face frame composed with the learned in-plane
    rotation (rotation columns [normal, R1, R2])."""
    fn, base_r1, base_r2 = face_frames(params, faces)
    cr = params.complex_rot
    cn = cr / torch.clamp_min(torch.linalg.norm(cr, dim=-1, keepdim=True), 1e-12)
    cn = cn.reshape(faces.shape[0], n_per_face, 2)
    r1 = cn[..., 0:1] * base_r1[:, None] + cn[..., 1:2] * base_r2[:, None]
    r2 = -cn[..., 1:2] * base_r1[:, None] + cn[..., 0:1] * base_r2[:, None]
    r0 = fn[:, None].expand(r1.shape)
    rot = torch.stack([r0, r1, r2], dim=-1)  # (F, G, 3, 3) columns
    return quaternion.from_rotation_matrix(rot.reshape(-1, 3, 3))


def gaussian_scaling(params: SuGaRParams, thickness: torch.Tensor) -> torch.Tensor:
    """(Ng, 3): [thickness, exp(s1), exp(s2)]."""
    ng = params.scales.shape[0]
    return torch.cat([thickness.reshape(1, 1).expand(ng, 1), torch.exp(params.scales)], dim=-1)


def gaussian_strengths(params: SuGaRParams) -> torch.Tensor:
    return torch.sigmoid(params.densities)


def sh_coordinates(params: SuGaRParams, color_clip: float = float("inf")) -> torch.Tensor:
    dc = torch.clamp(params.sh_dc, -color_clip, color_clip)
    return torch.cat([dc, params.sh_rest], dim=1)


def gs_normals(params: SuGaRParams, faces: torch.Tensor, n_per_face: int) -> torch.Tensor:
    """The face normal of each Gaussian."""
    return torch.repeat_interleave(mesh_ops.face_normals(params.points, faces), n_per_face, dim=0)


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


@register("sugar")
class SuGaRModel:
    Config = SuGaRConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = self.Config(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(self.Config, cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        # every allocated band is evaluated, as in the reference
        self.active_sh_degree = cfg.sh_levels - 1
        self.n_per_face = cfg.n_gaussians_per_surface_triangle
        self.bary_np, self.circle_radius = BARY_TABLES[self.n_per_face]
        self.topology: Optional[mesh_ops.MeshTopology] = None
        self.topology_t: Optional[mesh_ops.MeshTopology] = None
        self._bound_mesh = None
        if cfg.surface_mesh_to_bind_path:
            self.bind_mesh(*mesh_ops.load_obj(cfg.surface_mesh_to_bind_path))

    def bind_mesh(self, verts: np.ndarray, faces: np.ndarray,
                  vert_colors: Optional[np.ndarray] = None) -> None:
        """Binds the largest connected component of the mesh (vertex colours
        0.5 unless given) and builds its topology."""
        if vert_colors is None:
            vert_colors = np.full_like(verts, 0.5)
        verts, faces, vert_colors = mesh_ops.prune_isolated_components(verts, faces, vert_colors)
        self._bound_mesh = (verts.astype(np.float32), faces.astype(np.int32),
                            vert_colors.astype(np.float32))
        self.topology = mesh_ops.build_topology(faces, len(verts))
        self.topology_t = mesh_ops.MeshTopology(
            *(torch.as_tensor(a, device=self.device) for a in self.topology))

    def init_state(self, seed: int = 0) -> SuGaRState:
        """The bound mesh's Gaussians: tangent scales from each face's
        shortest edge, colours from the barycentric vertex colours, the
        identity in-plane rotation, opacity ``init_gs_opacity``; zeroed Adam
        moments.  Nothing is drawn (``seed`` is unused)."""
        if self._bound_mesh is None:
            raise ValueError("SuGaR requires a surface mesh (surface_mesh_to_bind_path or "
                             "bind_mesh from the gaussian-stage extraction)")
        cfg = self.cfg
        verts, faces, vert_colors = self._bound_mesh
        ng = len(faces) * self.n_per_face
        k_rest = num_sh_bases(cfg.sh_levels - 1) - 1 if cfg.sh_levels > 1 else 0
        fv = verts[faces]
        edge_len = np.linalg.norm(fv - fv[:, [1, 2, 0]], axis=-1).min(axis=-1)
        scales0 = np.maximum(edge_len * self.circle_radius, 1e-7)
        scales0 = np.log(scales0)[:, None, None].repeat(self.n_per_face, 1).repeat(2, 2)
        if cfg.gs_color_inherit_vertices:
            colors = np.einsum("gk,fkc->fgc", self.bary_np, vert_colors[faces]).reshape(-1, 3)
        else:
            colors = np.full((ng, 3), 0.5, np.float32)
        cr = np.zeros((ng, 2), np.float32)
        cr[:, 0] = 1.0

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

        params = SuGaRParams(
            points=dev(verts),
            sh_dc=rgb_to_sh(dev(colors))[:, None, :],
            sh_rest=torch.zeros((ng, k_rest, 3), device=self.device),
            scales=dev(scales0.reshape(ng, 2)),
            complex_rot=dev(cr),
            densities=inverse_sigmoid(torch.full((ng, 1), cfg.init_gs_opacity,
                                                 device=self.device)),
        )
        return SuGaRState(
            params=params, adam=init_adam(params.as_dict()),
            faces=torch.as_tensor(faces, dtype=torch.int64, device=self.device),
            bary=dev(self.bary_np),
            thickness=torch.tensor(np.float32(cfg.spatial_extent / 1_000_000), device=self.device),
        )

    # -- scheduled values ---------------------------------------------------
    def lr_tree(self, step: int) -> Dict[str, float]:
        cfg = self.cfg

        def c(v, scale=1.0):
            return float(np.float32(C(v, 0, step, interpolation="exp") * scale))

        feat = C(cfg.feature_lr, 0, step, interpolation="exp")
        return dict(
            points=c(cfg.position_lr, cfg.spatial_lr_scale),
            sh_dc=float(np.float32(feat)),
            sh_rest=float(np.float32(feat / 20.0)),
            scales=c(cfg.scaling_lr),
            complex_rot=c(cfg.rotation_lr),
            densities=c(cfg.opacity_lr),
        )

    def color_clip(self, step: int) -> float:
        return float(C(self.cfg.color_clip, 0, step))

    # -- the update tail of a train step --------------------------------------
    @torch.no_grad()
    def apply_gradients(self, state: SuGaRState, grads: Dict[str, torch.Tensor],
                        lrs: Dict[str, float]) -> SuGaRState:
        """One Adam step (eps 1e-15) over every param."""
        new = adam_update(state.params.as_dict(), grads, state.adam, lrs)
        return dataclasses.replace(state, params=dataclasses.replace(state.params, **new))

    def accumulate_stats(self, state: SuGaRState, *_) -> SuGaRState:
        """No densify statistics."""
        return state

    def update_states(self, state: SuGaRState, iteration: int, generator=None, draws=None):
        """The mesh-bound Gaussians are never densified or pruned."""
        return state, False

    # -- conversions --------------------------------------------------------
    def as_gaussian_arrays(self, state: SuGaRState, color_clip: float = float("inf")
                           ) -> Dict[str, torch.Tensor]:
        """Everything the rasterizer needs, derived from the mesh binding."""
        p = state.params
        return dict(
            means3d=gaussian_positions(p, state.faces, state.bary),
            scales=gaussian_scaling(p, state.thickness),
            quats=gaussian_quaternions(p, state.faces, self.n_per_face),
            opacities=gaussian_strengths(p)[:, 0],
            sh_coeffs=sh_coordinates(p, color_clip),
            normals=gs_normals(p, state.faces, self.n_per_face),
        )

    # -- border-face postprocess before the texture bake ----------------------
    @torch.no_grad()
    def compute_density(self, state: SuGaRState, points: torch.Tensor, k: int = 16
                        ) -> torch.Tensor:
        """Density at world points: the sum over the k nearest Gaussians of
        strength * exp(-1/2 d^T Sigma^-1 d), on the Gaussians' device."""
        from ..ops.knn import knn

        arrays = self.as_gaussian_arrays(state)
        means = arrays["means3d"]
        k = min(k, means.shape[0])
        points = points.to(means.device, torch.float32)
        # queries in chunks of at most 2^28 distances (1 GiB): a chunk of
        # the knn's default 4096 rows against the 2.8M Gaussians of a
        # 470k-face mesh would hold 46 GB
        _, idx = knn(points, means, k, chunk=max(1, min(4096, (1 << 28) // means.shape[0])))
        d = points[:, None, :] - means[idx]  # (P, K, 3)
        rot = quaternion.to_rotation_matrix(arrays["quats"][idx])
        local = torch.einsum("pkij,pki->pkj", rot, d)  # R^T d
        inv_var = 1.0 / torch.clamp_min(arrays["scales"][idx] ** 2, 1e-12)
        q = torch.sum(local * local * inv_var, dim=-1)
        return torch.sum(arrays["opacities"][idx] * torch.exp(-0.5 * q), dim=-1)

    @torch.no_grad()
    def postprocess_state(self, state: SuGaRState, density_threshold: float = 0.1,
                          iterations: int = 5) -> SuGaRState:
        """Peel ``iterations`` rings of border faces, then re-add the peeled
        faces whose centre density exceeds the threshold.  The per-face
        Gaussians' params are subset, the vertices kept, the topology
        rebuilt and Adam re-initialised (this runs after training)."""
        faces = state.faces.cpu().numpy()
        mask = mesh_ops.peel_border_faces(faces, iterations)
        removed = np.nonzero(~mask)[0]
        if len(removed):
            verts = state.params.points
            centers = verts[state.faces[torch.as_tensor(removed, device=verts.device)]].mean(dim=1)
            dens = self.compute_density(state, centers)
            mask[removed] = (dens > density_threshold).cpu().numpy()
        if mask.all():
            return state
        if not mask.any():
            raise ValueError("postprocess would remove every face")
        dev = state.faces.device
        gmask = torch.as_tensor(np.repeat(mask, self.n_per_face), device=dev)
        p = state.params
        new_params = SuGaRParams(
            points=p.points, sh_dc=p.sh_dc[gmask], sh_rest=p.sh_rest[gmask],
            scales=p.scales[gmask], complex_rot=p.complex_rot[gmask],
            densities=p.densities[gmask])
        self.topology = mesh_ops.build_topology(faces[mask], p.points.shape[0])
        self.topology_t = mesh_ops.MeshTopology(
            *(torch.as_tensor(a, device=self.device) for a in self.topology))
        return dataclasses.replace(
            state, params=new_params, adam=init_adam(new_params.as_dict()),
            faces=state.faces[torch.as_tensor(mask, device=dev)])

    def save_mesh_obj(self, state: SuGaRState, path: str) -> None:
        """The bound mesh (its vertices as trained, its faces) as an OBJ."""
        from .mesh_extract import save_obj

        save_obj(path, state.params.points.detach().cpu().numpy(), state.faces.cpu().numpy())

    @torch.no_grad()
    def save_ply(self, state: SuGaRState, path: str) -> None:
        """Every bound Gaussian as a 3DGS PLY (log scales, the thickness
        included)."""
        from . import ply_io

        arrays = {k: v.detach().cpu().numpy() for k, v in self.as_gaussian_arrays(state).items()}
        p = state.params
        ply_io.save_gaussian_ply(
            path, xyz=arrays["means3d"], features_dc=p.sh_dc.cpu().numpy(),
            features_rest=p.sh_rest.cpu().numpy(), opacity=p.densities.cpu().numpy(),
            scaling=np.log(np.maximum(arrays["scales"], 1e-10)), rotation=arrays["quats"],
        )
