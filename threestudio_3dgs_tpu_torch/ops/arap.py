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
    its edges in one direction only).  Each vertex's neighbours are in the
    order the JAX package's loop meets them: over the faces' edges (i, j)
    in order, j joins i's ring and then i joins j's, each once."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    i, j = f, np.roll(f, -1, axis=1)
    # the loop's events in order: (owner i, neighbour j), then (j, i)
    owners = np.stack([i, j], axis=-1).reshape(-1)
    nbrs = np.stack([j, i], axis=-1).reshape(-1)
    _, first = np.unique(owners * n_verts + nbrs, return_index=True)
    first = first[np.lexsort((first, owners[first]))]  # by owner, then first seen
    owner, nbr = owners[first], nbrs[first]
    degree = np.bincount(owner, minlength=n_verts)
    starts = np.concatenate([[0], np.cumsum(degree)[:-1]])
    rank = np.arange(len(owner)) - starts[owner]
    width = max(max_degree, int(degree.max(initial=0)))
    idx = np.zeros((n_verts, width), np.int32)
    mask = np.zeros((n_verts, width), np.float32)
    idx[owner, rank] = nbr
    mask[owner, rank] = 1.0
    return idx, mask


def cotangent_weights(verts: torch.Tensor, faces: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """Half the cotangents of the angles opposite each edge, summed over its
    faces, gathered into the padded neighbour table and clamped at 0.  The
    JAX package accumulates into a dense (V, V) matrix; here each directed
    edge's terms are summed under the key i V + j and the table's entries
    looked up by theirs, so a mesh of any size fits (the same sums: an edge
    of two faces adds its two terms to 0 in either order)."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]

    def cot(a, b):
        cos = torch.sum(a * b, dim=-1)
        sin = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
        return cos / torch.clamp_min(sin, 1e-8)

    n_verts = verts.shape[0]
    rows, cols, vals = [], [], []
    for i, j, c in ((faces[:, 1], faces[:, 2], cot(v1 - v0, v2 - v0)),
                    (faces[:, 0], faces[:, 2], cot(v0 - v1, v2 - v1)),
                    (faces[:, 0], faces[:, 1], cot(v0 - v2, v1 - v2))):
        rows += [i, j]
        cols += [j, i]
        vals += [0.5 * c, 0.5 * c]
    keys, inverse = torch.unique(torch.cat(rows) * n_verts + torch.cat(cols),
                                 return_inverse=True)
    sums = torch.zeros(keys.shape, dtype=verts.dtype, device=verts.device)
    sums = sums.index_add(0, inverse, torch.cat(vals))
    want = torch.arange(n_verts, device=verts.device)[:, None] * n_verts + nbr_idx.long()
    pos = torch.clamp(torch.searchsorted(keys, want), max=keys.shape[0] - 1)
    table = torch.where(keys[pos] == want, sums[pos], torch.zeros_like(sums[pos]))
    return torch.clamp_min(table * nbr_mask, 0.0)


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
    full table with zero masks there gives.  The masked entries gather the
    row's own vertex: the same zero terms, and the gathers' backward then
    adds no run of duplicates into the padding's vertex, which the card's
    index backward walks serially."""
    if weights is None:
        weights = nbr_mask
    own = (torch.arange(verts_rest.shape[0], device=verts_rest.device) if rows is None
           else rows)
    nbr_idx = torch.where(nbr_mask > 0, nbr_idx.long(), own[:, None])
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
