"""Triangle-mesh ops (port of the JAX package's ``ops/mesh.py``): face and
vertex normals, the host-side topology of the smoothness energies, normal
consistency and uniform Laplacian smoothing, the largest-component prune,
PCA point-cloud normals, border-face peeling and a minimal OBJ reader.

Connectivity is built on the host in numpy once per topology; the
energies are torch functions of the vertex positions, so they
differentiate into the mesh."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .arap import build_one_ring


def _safe_unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    """L2-normalise with zero vectors -> zero output and zero gradient (a
    plain v / max(|v|, eps) leaks NaN through the backward at v = 0)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    is_zero = sq < eps * eps
    safe_sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(v), v * torch.rsqrt(safe_sq))


def _face_cross(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)


def face_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12) -> torch.Tensor:
    return _safe_unit(_face_cross(verts, faces), eps)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12) -> torch.Tensor:
    """Area-weighted vertex normals (the face cross products summed onto
    their corners)."""
    fn = _face_cross(verts, faces)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k].long(), fn)
    return _safe_unit(vn, eps)


class MeshTopology(NamedTuple):
    """Host-precomputed connectivity for the smoothness energies."""

    edge_faces: np.ndarray  # (E2, 2) pairs of faces sharing an interior edge
    vert_nbr_idx: np.ndarray  # (V, D) padded one-ring
    vert_nbr_mask: np.ndarray  # (V, D)


def build_topology(faces: np.ndarray, n_verts: int, max_degree: int = 16) -> MeshTopology:
    """The first two faces of every edge shared by two or more faces (edges
    in first-seen order), and the padded one-ring."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    i, j = f, np.roll(f, -1, axis=1)
    key = (np.minimum(i, j) * n_verts + np.maximum(i, j)).reshape(-1)  # face-major
    order = np.argsort(key, kind="stable")  # each edge's faces stay in face order
    sk = key[order]
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(sk)]]))
    shared = starts[sizes >= 2]
    first, second = order[shared], order[shared + 1]
    seen = np.argsort(first)  # edges in first-seen order
    edge_faces = np.stack([first[seen] // 3, second[seen] // 3], axis=1).astype(np.int32)
    nbr_idx, nbr_mask = build_one_ring(faces, n_verts, max_degree)
    return MeshTopology(edge_faces.reshape(-1, 2), nbr_idx, nbr_mask)


def normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                            edge_faces: torch.Tensor) -> torch.Tensor:
    """Mean (1 - cos) between the normals of faces sharing an edge
    (pytorch3d's mesh_normal_consistency)."""
    if edge_faces.shape[0] == 0:
        return torch.zeros((), device=verts.device)
    fn = face_normals(verts, faces)
    edge_faces = edge_faces.long()
    return torch.mean(1.0 - torch.sum(fn[edge_faces[:, 0]] * fn[edge_faces[:, 1]], dim=-1))


def laplacian_smoothing_loss(verts: torch.Tensor, nbr_idx: torch.Tensor,
                             nbr_mask: torch.Tensor) -> torch.Tensor:
    """Mean uniform-weight Laplacian magnitude over the vertices with
    neighbours (pytorch3d's mesh_laplacian_smoothing(method="uniform")),
    with a gradient-safe norm at 0.  The padding entries of the one-ring
    (index 0, mask 0) gather the vertex itself instead: the same zero
    terms, and the gather's backward then adds no run of duplicates into
    vertex 0, which the card's index backward walks serially."""
    own = torch.arange(verts.shape[0], device=verts.device)[:, None]
    nbrs = verts[torch.where(nbr_mask > 0, nbr_idx.long(), own)]  # (V, D, 3)
    count = torch.sum(nbr_mask, dim=1, keepdim=True)
    mean_nbr = torch.sum(nbrs * nbr_mask[..., None], dim=1) / torch.clamp_min(count, 1.0)
    lap = mean_nbr - verts
    has_nbr = (count[:, 0] > 0).to(verts.dtype)
    sq = torch.sum(lap * lap, dim=-1)
    is_zero = sq < 1e-24
    lap_norm = torch.where(is_zero, torch.zeros_like(sq),
                           torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))
    return torch.sum(lap_norm * has_nbr) / torch.clamp_min(torch.sum(has_nbr), 1.0)


def prune_isolated_components(verts: np.ndarray, faces: np.ndarray, vert_attrs: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keep only the largest connected component (host-side union-find;
    ties go to the lowest root index)."""
    n = len(verts)
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for tri in faces:
        a = find(int(tri[0]))
        for k in (1, 2):
            b = find(int(tri[k]))
            if a != b:
                parent[b] = a
    roots = np.array([find(i) for i in range(n)])
    unique, counts = np.unique(roots, return_counts=True)
    keep = roots == unique[np.argmax(counts)]
    remap = -np.ones(n, np.int64)
    remap[keep] = np.arange(keep.sum())
    new_faces = remap[faces[keep[faces].all(axis=1)]]
    return verts[keep], new_faces.astype(np.int32), vert_attrs[keep]


def estimate_pointcloud_normals(points: torch.Tensor, neighborhood_size: int = 32,
                                disambiguate_directions: bool = True) -> torch.Tensor:
    """Per-point PCA normals (pytorch3d's estimate_pointcloud_normals): the
    eigenvector of the smallest eigenvalue of the K-neighbourhood's
    covariance (self included), flipped to point away from the local
    centroid."""
    from .knn import knn

    points = points.float()
    _, idx = knn(points, points, neighborhood_size)
    nbr = points[idx]  # (N, K, 3)
    mean = nbr.mean(dim=1)
    d = nbr - mean[:, None, :]
    cov = torch.einsum("nki,nkj->nij", d, d) / neighborhood_size
    _, v = torch.linalg.eigh(cov)  # ascending eigenvalues
    normals = v[..., 0]
    if disambiguate_directions:
        proj = torch.sum(normals * (mean - points), dim=-1)
        normals = torch.where(proj[:, None] > 0, -normals, normals)
    return normals


def peel_border_faces(faces: np.ndarray, iterations: int = 5) -> np.ndarray:
    """Boolean keep-mask over faces after peeling `iterations` rings of
    border faces: a face stays while each of its 3 edges is shared with
    another face still kept (host-side numpy)."""
    faces = np.asarray(faces, np.int64)
    face_mask = np.ones(len(faces), bool)
    edges = np.sort(np.stack([faces[:, (0, 1)], faces[:, (1, 2)], faces[:, (2, 0)]], axis=1),
                    axis=-1)
    n_verts = int(faces.max()) + 1 if len(faces) else 0
    keys = edges[..., 0] * n_verts + edges[..., 1]  # (F, 3)
    for _ in range(iterations):
        live = np.nonzero(face_mask)[0]
        sub = keys[live]
        uniq, counts = np.unique(sub, return_counts=True)
        inside = (counts[np.searchsorted(uniq, sub)] >= 2).all(axis=1)
        if inside.all():
            break
        face_mask[live] = inside
    return face_mask


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: triangles and fan-triangulated polygons, positive
    or negative (relative) vertex indices."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                raw = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in raw]
                for a, b in zip(idx[1:-1], idx[2:]):
                    faces.append([idx[0], a, b])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def icosphere(subdivisions=2, radius=0.5):
    """An icosahedron split `subdivisions` times (320 faces at 2), its
    vertices on a sphere, outward winding: (verts (V, 3) f32, faces (F, 3)
    i32)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid, new = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return (np.asarray(verts) * radius).astype(np.float32), np.asarray(faces, np.int32)
