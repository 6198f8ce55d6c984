"""Mesh extraction from free Gaussians.

Replaces the reference's density-grid + mcubes pipeline (reference
geometry/gaussian_io.py:174-291) with a from-scratch implementation:

  * density grid: per-Gaussian local-box splatting of the 3D Gaussian density
    (opacity * exp(-0.5 d^T Sigma^-1 d), the same gaussian_3d_coeff math as
    reference geometry/gaussian_base.py:63-96), max-combined per voxel -- the
    reference's blocked query loop inverted into a scatter, which bounds work
    by N * box^3 instead of grid^3 * N;
  * isosurface: naive surface nets (one vertex per sign-change cell at the
    centroid of edge crossings, quads across sign-change edges) instead of
    table-based marching cubes -- no lookup tables, watertight output, and
    vertices land on the smoothed surface.

Export-time tooling: runs in numpy on host (not a training-path op).  The
port's own copy of the JAX package's ``models/mesh_extract.py``; only the
covariances go through the port's ``ops/gaussian_math.py`` in torch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def density_grid_from_gaussians(
    xyz: np.ndarray,  # (N, 3)
    cov6: np.ndarray,  # (N, 6) stripped covariances
    opacity: np.ndarray,  # (N,)
    resolution: int = 128,
    box_cells: int = 9,
    bound: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Max-combined opacity-weighted density on a cubic grid.

    Returns (grid (R,R,R), origin (3,), cell_size)."""
    n = xyz.shape[0]
    if bound is None:
        if n == 0:
            bound = 1.0
        else:
            lo = np.percentile(xyz, 1, axis=0)
            hi = np.percentile(xyz, 99, axis=0)
            bound = float(np.max(np.abs(np.concatenate([lo, hi])))) * 1.1 + 1e-3
    origin = np.array([-bound] * 3, np.float32)
    cell = 2.0 * bound / (resolution - 1)

    grid = np.zeros((resolution, resolution, resolution), np.float32)
    if n == 0:
        return grid, origin, cell

    half = box_cells // 2
    offs = np.arange(-half, half + 1)
    ox, oy, oz = np.meshgrid(offs, offs, offs, indexing="ij")
    cell_offsets = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3)  # (B, 3)

    # precompute inverse covariances (reference gaussian_3d_coeff)
    a, b, c, d, e, f = (cov6[:, i] for i in range(6))
    det = a * d * f + 2 * e * c * b - e * e * a - c * c * d - b * b * f
    inv_det = 1.0 / (det + 1e-24)
    inv = np.stack(
        [
            (d * f - e * e) * inv_det,  # xx
            (e * c - b * f) * inv_det,  # xy
            (e * b - c * d) * inv_det,  # xz
            (a * f - c * c) * inv_det,  # yy
            (b * c - e * a) * inv_det,  # yz
            (a * d - b * b) * inv_det,  # zz
        ],
        axis=1,
    ).astype(np.float32)

    center_cells = np.round((xyz - origin) / cell).astype(np.int64)  # (N, 3)
    chunk = 65536
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        cc = center_cells[sl]  # (M, 3)
        cells = cc[:, None, :] + cell_offsets[None, :, :]  # (M, B, 3)
        pts = origin + cells * cell  # world positions of sampled voxels
        dvec = pts - xyz[sl][:, None, :]  # (M, B, 3)
        x, y, z = dvec[..., 0], dvec[..., 1], dvec[..., 2]
        iv = inv[sl][:, None, :]
        power = -0.5 * (
            x * x * iv[..., 0] + y * y * iv[..., 3] + z * z * iv[..., 5]
        ) - x * y * iv[..., 1] - x * z * iv[..., 2] - y * z * iv[..., 4]
        val = np.where(power > 0, 0.0, np.exp(power)) * opacity[sl][:, None]
        inside = np.all((cells >= 0) & (cells < resolution), axis=-1)
        cells_flat = (
            cells[..., 0] * resolution * resolution
            + cells[..., 1] * resolution
            + cells[..., 2]
        )
        cells_flat = np.where(inside, cells_flat, 0)
        val = np.where(inside, val, 0.0)
        np.maximum.at(grid.reshape(-1), cells_flat.reshape(-1), val.reshape(-1))
    return grid, origin, cell


def surface_nets(
    grid: np.ndarray, iso: float, origin: np.ndarray, cell: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets isosurface extraction.

    Returns (verts (V, 3) float32, faces (F, 3) int32).  Faces are oriented so
    normals point toward decreasing density (outward)."""
    occ = grid > iso
    r = np.array(grid.shape)

    # cells = voxels between grid corners; a cell is "active" if its 8
    # corners have mixed occupancy
    corner = occ
    c000 = corner[:-1, :-1, :-1]
    c100 = corner[1:, :-1, :-1]
    c010 = corner[:-1, 1:, :-1]
    c110 = corner[1:, 1:, :-1]
    c001 = corner[:-1, :-1, 1:]
    c101 = corner[1:, :-1, 1:]
    c011 = corner[:-1, 1:, 1:]
    c111 = corner[1:, 1:, 1:]
    csum = (
        c000.astype(np.int8)
        + c100
        + c010
        + c110
        + c001
        + c101
        + c011
        + c111
    )
    active = (csum > 0) & (csum < 8)
    cell_ids = -np.ones(active.shape, np.int64)
    ax, ay, az = np.nonzero(active)
    cell_ids[ax, ay, az] = np.arange(len(ax))

    if len(ax) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # vertex per active cell: centroid of edge crossings (linear interp)
    corners_idx = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
            [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
        ]
    )
    edges = [
        (0, 1), (2, 3), (4, 5), (6, 7),  # x edges
        (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
        (0, 4), (1, 5), (2, 6), (3, 7),  # z edges
    ]
    base = np.stack([ax, ay, az], axis=1)  # (M, 3)
    vals = np.stack(
        [
            grid[ax + dx, ay + dy, az + dz]
            for dx, dy, dz in corners_idx
        ],
        axis=1,
    )  # (M, 8)
    pos_sum = np.zeros((len(ax), 3), np.float64)
    cnt = np.zeros(len(ax), np.float64)
    for e0, e1 in edges:
        v0, v1 = vals[:, e0], vals[:, e1]
        cross = (v0 > iso) != (v1 > iso)
        t = np.where(cross, (iso - v0) / np.where(v1 == v0, 1.0, v1 - v0), 0.0)
        t = np.clip(t, 0.0, 1.0)
        p = corners_idx[e0] + t[:, None] * (corners_idx[e1] - corners_idx[e0])
        pos_sum += np.where(cross[:, None], p, 0.0)
        cnt += cross
    verts_cell = base + pos_sum / np.maximum(cnt, 1.0)[:, None]
    verts = (origin + verts_cell * cell).astype(np.float32)

    # faces: for each grid edge with a sign change, connect the 4 cells
    # sharing it.  Axis-aligned edge along axis k at corner (i,j,l): the four
    # adjacent cells are offset by -1/0 in the two other axes.
    faces = []
    for axis in range(3):
        o1 = (axis + 1) % 3
        o2 = (axis + 2) % 3
        shift = np.zeros(3, np.int64)
        shift[axis] = 1
        e0 = occ[: r[0] - shift[0], : r[1] - shift[1], : r[2] - shift[2]]
        e1 = occ[shift[0]:, shift[1]:, shift[2]:]
        cross = e0 != e1
        ex, ey, ez = np.nonzero(cross)
        corner_pos = np.stack([ex, ey, ez], axis=1)
        # skip boundary edges that do not have 4 surrounding cells
        ok = (corner_pos[:, o1] > 0) & (corner_pos[:, o2] > 0)
        ok &= (corner_pos[:, o1] <= active.shape[o1] - 1) & (
            corner_pos[:, o2] <= active.shape[o2] - 1
        )
        ok &= corner_pos[:, axis] <= active.shape[axis] - 1
        corner_pos = corner_pos[ok]
        if len(corner_pos) == 0:
            continue
        flip = e1[ex, ey, ez][ok]  # True if density increases along +axis

        def cid(dp1, dp2):
            p = corner_pos.copy()
            p[:, o1] -= dp1
            p[:, o2] -= dp2
            return cell_ids[p[:, 0], p[:, 1], p[:, 2]]

        q0, q1, q2, q3 = cid(1, 1), cid(0, 1), cid(0, 0), cid(1, 0)
        quad = np.stack([q0, q1, q2, q3], axis=1)
        good = np.all(quad >= 0, axis=1)
        quad = quad[good]
        flip_g = flip[good]
        t1 = np.where(
            flip_g[:, None], quad[:, [0, 1, 2]], quad[:, [0, 2, 1]]
        )
        t2 = np.where(
            flip_g[:, None], quad[:, [0, 2, 3]], quad[:, [0, 3, 2]]
        )
        faces.append(t1)
        faces.append(t2)
    if not faces:
        return verts, np.zeros((0, 3), np.int32)
    faces = np.concatenate(faces, axis=0).astype(np.int32)
    return verts, faces


def extract_mesh_from_gaussians(
    gauss_state,
    resolution: int = 128,
    density_thresh: float = 0.8,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Full pipeline from a GaussianState (alive rows only)."""
    import torch

    from ..ops.gaussian_math import covariance_from_scaling_rotation, strip_symmetric
    from . import gaussian_field as gf

    alive = gauss_state.alive
    params = gauss_state.params
    with torch.no_grad():
        scales = gf.get_scaling(params)[alive]
        quats = params.rotation[alive]
        if scales.shape[0] == 0:
            return None, None
        cov6 = strip_symmetric(covariance_from_scaling_rotation(scales, quats)).cpu().numpy()
        xyz = params.xyz[alive].cpu().numpy()
        opacity = gf.get_opacity(params)[alive, 0].cpu().numpy()
    grid, origin, cell = density_grid_from_gaussians(
        xyz, cov6, opacity, resolution=resolution
    )
    # reference thresholds at density_thresh relative to the max (gaussian_io
    # uses an absolute opacity threshold; we normalize for robustness)
    iso = density_thresh * max(float(grid.max()), 1e-6)
    return surface_nets(grid, iso, origin, cell)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
