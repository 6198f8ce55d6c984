"""As-rigid-as-possible (ARAP) energy (port of the JAX package's
``ops/arap.py``).

One-ring neighbourhoods with cotangent edge weights, and the ARAP energy
with given per-vertex rotations or the SVD-fitted optimal ones (the
determinant flip corrected, no gradient through the fit).  Neighbourhoods
are fixed-width padded index tables; ``arap_energy_knn`` is the point-cloud
form on k-NN tables that the 4D system's lite ARAP uses."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def build_one_ring(faces: np.ndarray, n_verts: int, max_degree: int = 16):
    """Padded one-ring table of a triangle list (host-side numpy): (nbr_idx
    (V, D) int32, nbr_mask (V, D)).  ``max_degree`` is a lower bound on D,
    which grows to the mesh's largest degree (truncating a vertex would drop
    its edges in one direction only)."""
    neighbors = [[] for _ in range(n_verts)]
    for tri in faces:
        for a in range(3):
            i, j = int(tri[a]), int(tri[(a + 1) % 3])
            if j not in neighbors[i]:
                neighbors[i].append(j)
            if i not in neighbors[j]:
                neighbors[j].append(i)
    degree = max((len(nb) for nb in neighbors), default=0)
    width = max(max_degree, degree)
    idx = np.zeros((n_verts, width), np.int32)
    mask = np.zeros((n_verts, width), np.float32)
    for i, nbrs in enumerate(neighbors):
        idx[i, : len(nbrs)] = nbrs
        mask[i, : len(nbrs)] = 1.0
    return idx, mask


def cotangent_weights(verts: torch.Tensor, faces: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """Half the cotangents of the angles opposite each edge, summed over its
    faces, gathered into the padded neighbour table and clamped at 0.  A
    dense (V, V) accumulator: for meshes of modest size."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]

    def cot(a, b):
        cos = torch.sum(a * b, dim=-1)
        sin = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
        return cos / torch.clamp_min(sin, 1e-8)

    n_verts = verts.shape[0]
    w = torch.zeros((n_verts, n_verts), dtype=verts.dtype, device=verts.device)
    for i, j, c in ((faces[:, 1], faces[:, 2], cot(v1 - v0, v2 - v0)),
                    (faces[:, 0], faces[:, 2], cot(v0 - v1, v2 - v1)),
                    (faces[:, 0], faces[:, 1], cot(v0 - v2, v1 - v2))):
        w = w.index_put((i, j), 0.5 * c, accumulate=True)
        w = w.index_put((j, i), 0.5 * c, accumulate=True)
    rows = torch.arange(n_verts, device=verts.device)[:, None]
    return torch.clamp_min(w[rows, nbr_idx.long()] * nbr_mask, 0.0)


def fit_rotations(p_rest: torch.Tensor, p_def: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Per-vertex optimal rotations (V, 3, 3) from the SVD of the weighted
    edge covariance, the last column of V flipped where det < 0."""
    cov = torch.einsum("vdi,vd,vdj->vij", p_rest, weights, p_def)
    u, _, vt = torch.linalg.svd(cov)
    r = torch.einsum("vji,vkj->vik", vt, u)  # V U^T
    sign = torch.where(torch.linalg.det(r) < 0, -1.0, 1.0)
    vt = torch.cat([vt[:, :-1, :], vt[:, -1:, :] * sign[:, None, None]], dim=1)
    return torch.einsum("vji,vkj->vik", vt, u)


def arap_energy(verts_rest: torch.Tensor, verts_def: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_mask: torch.Tensor, weights: Optional[torch.Tensor] = None,
                rotations: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_i sum_j w_ij || (p_i' - p_j') - R_i (p_i - p_j) ||^2.  ``rows``
    (R,): the vertices the tables' R rows belong to, when only those terms
    are wanted (every vertex by default); the sum over the rest is what a
    full table with zero masks there gives."""
    if weights is None:
        weights = nbr_mask
    nbr_idx = nbr_idx.long()
    rest_i = verts_rest if rows is None else verts_rest[rows]
    def_i = verts_def if rows is None else verts_def[rows]
    e_rest = (rest_i[:, None, :] - verts_rest[nbr_idx]) * nbr_mask[..., None]
    e_def = (def_i[:, None, :] - verts_def[nbr_idx]) * nbr_mask[..., None]
    if rotations is None:
        with torch.no_grad():
            rotations = fit_rotations(e_rest, e_def, weights)
    diff = e_def - torch.einsum("vij,vdj->vdi", rotations, e_rest)
    return torch.sum(weights * torch.sum(diff * diff, dim=-1))


def arap_energy_knn(pts_rest: torch.Tensor, pts_def: torch.Tensor, nbr_idx: torch.Tensor,
                    nbr_mask: Optional[torch.Tensor] = None,
                    rotations: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ARAP on a point cloud with k-NN neighbourhoods ((N, K), or (R, K)
    for the given ``rows``)."""
    if nbr_mask is None:
        nbr_mask = torch.ones(nbr_idx.shape, dtype=pts_rest.dtype, device=pts_rest.device)
    return arap_energy(pts_rest, pts_def, nbr_idx, nbr_mask, rotations=rotations, rows=rows)
