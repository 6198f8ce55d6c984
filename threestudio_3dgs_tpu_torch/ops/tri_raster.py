"""Z-buffered triangle id-pass (port of the JAX package's
``ops/tri_raster.py``), the rasterizer of SuGaR's texture bake.

Per pixel it returns the nearest face's id, the pixel's screen-space
barycentrics in it and the view depth of the hit, plus two drop counters,
by the JAX package's algorithm step for step:

  1. project the vertices with the ``ndc2Pix`` convention of ``ops/camera.py``
     (pixel centres at integer coordinates, no +0.5);
  2. bin the faces with every vertex in front of ``znear`` and a bounding
     box on screen to ``tile x tile`` pixel tiles, expanded into at most
     ``max_pairs`` (tile, face) pairs in face order (the rest are counted in
     ``n_dropped_pairs``);
  3. order the pairs by a stable sort on the tile, so each tile lists its
     faces in ascending id, and keep the first ``max_faces_per_tile`` of each
     (the rest are counted in ``n_dropped_tile``);
  4. walk each tile's list in chunks of ``chunk`` faces: a pixel is covered
     by either winding where all three edge functions share the sign of an
     area beyond 1e-9, its depth is interpolated with the screen-space
     barycentrics, and a running z-min keeps the first face of the smallest
     depth in the chunk, which replaces the pixel's hit only where it is
     strictly nearer: on a z tie the face earlier in the tile's list wins.

Nothing here is differentiated (the bake runs after training).  There is
no Pallas kernel behind it in the JAX package; this is plain torch on the
port's device.  The sums and products are written out in the order, and
with the fused multiply-adds, that XLA's CPU compiler gives the JAX
function (the clip coordinates as (p0 + p1) + (p2 + p3), the view depth as
a chain of fused multiply-adds, a b - c d as fma(a, b, -(c d))), so the
port's CPU pixels equal the JAX package's."""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriRasterOut(NamedTuple):
    face_id: torch.Tensor  # (H, W) int64, -1 where no face
    bary: torch.Tensor  # (H, W, 3) screen-space barycentrics of the hit
    zbuf: torch.Tensor  # (H, W) view-space depth of the hit, -1 where none
    n_dropped_pairs: torch.Tensor  # () pairs past max_pairs
    n_dropped_tile: torch.Tensor  # () pairs past max_faces_per_tile


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding (the product of two f32 is exact in
    f64, and the f64 sum rounds to the fused value but for ties below f32's
    half ulp)."""
    return (a.double() * b.double() + c.double()).float()


def _cross(e: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Edge function e x d of edges (T, c, 2) and pixel offsets (T, c, P, 2),
    as fma(ex, dy, -(ey dx))."""
    return _fma(e[..., None, 0].expand_as(d[..., 1]), d[..., 1], -(e[..., None, 1] * d[..., 0]))


def project_vertices(verts: torch.Tensor, w2c: torch.Tensor, full_proj: torch.Tensor,
                     height: int, width: int):
    """(V, 2) pixel coordinates and (V,) view depth of world points."""
    ones = torch.ones((verts.shape[0], 1), dtype=torch.float32, device=verts.device)
    vh = torch.cat([verts, ones], dim=-1)
    prod = [vh[:, k:k + 1] * full_proj[:, k] for k in range(4)]
    clip = (prod[0] + prod[1]) + (prod[2] + prod[3])
    w = clip[:, 3]
    safe_w = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[:, :2] / safe_w[:, None]
    one = torch.ones_like(w)
    px = _fma(ndc[:, 0] + 1.0, width * one, -one) * 0.5
    py = _fma(ndc[:, 1] + 1.0, height * one, -one) * 0.5
    depth = vh[:, 0] * w2c[2, 0]
    for k in range(1, 4):
        depth = _fma(vh[:, k], w2c[2, k], depth)
    return torch.stack([px, py], dim=-1), depth


@torch.no_grad()
def rasterize_triangles(
    verts: torch.Tensor,  # (V, 3) world space
    faces: torch.Tensor,  # (F, 3) integer
    w2c: torch.Tensor,  # (4, 4) world -> camera (OpenCV, +z forward)
    full_proj: torch.Tensor,  # (4, 4) world -> clip
    *,
    height: int,
    width: int,
    znear: float = 0.1,
    tile: int = 16,
    max_pairs: int = 1 << 18,
    max_faces_per_tile: int = 256,
    chunk: int = 8,
) -> TriRasterOut:
    dev = verts.device
    verts = verts.float()
    faces = faces.long()
    w2c, full_proj = w2c.float().to(dev), full_proj.float().to(dev)
    n_faces = faces.shape[0]

    # 1. project the vertices
    pts, vdepth = project_vertices(verts, w2c, full_proj, height, width)
    fv = pts[faces]  # (F, 3, 2)
    fz = vdepth[faces]  # (F, 3)

    # 2. face -> tile bounding boxes, expanded to pairs in face order
    n_tx = -(-width // tile)
    n_ty = -(-height // tile)
    n_tiles = n_tx * n_ty
    in_front = torch.all(fz > znear, dim=-1)
    xmin, xmax = fv[..., 0].amin(dim=-1), fv[..., 0].amax(dim=-1)
    ymin, ymax = fv[..., 1].amin(dim=-1), fv[..., 1].amax(dim=-1)
    on_screen = (xmax >= 0) & (xmin <= width - 1) & (ymax >= 0) & (ymin <= height - 1)
    valid = in_front & on_screen

    def tile_of(x, n):
        return torch.clamp(torch.floor(x / tile), 0, n - 1).long()

    tx0, tx1 = tile_of(xmin, n_tx), tile_of(xmax, n_tx)
    ty0, ty1 = tile_of(ymin, n_ty), tile_of(ymax, n_ty)
    bw = tx1 - tx0 + 1
    counts = torch.where(valid, bw * (ty1 - ty0 + 1), torch.zeros_like(bw))
    offsets = torch.cumsum(counts, 0) - counts  # exclusive
    total = int(counts.sum()) if n_faces else 0
    n_dropped_pairs = torch.tensor(max(total - max_pairs, 0), device=dev)
    n_pairs = min(total, max_pairs)
    pair_face = torch.repeat_interleave(torch.arange(n_faces, device=dev), counts)[:n_pairs]
    ordinal = torch.arange(n_pairs, device=dev) - offsets[pair_face]
    p_bw = torch.clamp_min(bw[pair_face], 1)
    d_y = torch.div(ordinal, p_bw, rounding_mode="floor")
    d_x = ordinal - d_y * p_bw
    pair_tile = (ty0[pair_face] + d_y) * n_tx + (tx0[pair_face] + d_x)

    # 3. a stable sort by tile: each tile's faces in ascending id
    pair_tile, order = torch.sort(pair_tile, stable=True)
    pair_face = pair_face[order]
    tile_ids = torch.arange(n_tiles, device=dev)
    start = torch.searchsorted(pair_tile, tile_ids, side="left")
    end = torch.searchsorted(pair_tile, tile_ids + 1, side="left")
    tcount = end - start
    n_dropped_tile = torch.clamp_min(tcount - max_faces_per_tile, 0).sum()
    kept = torch.clamp_max(tcount, max_faces_per_tile)

    # pixel coordinates of each tile, (T, P, 2), P = tile * tile row-major
    lx = torch.arange(tile, dtype=torch.float32, device=dev)
    gx = ((tile_ids % n_tx) * tile)[:, None, None] + lx[None, None, :]
    gy = ((tile_ids // n_tx) * tile)[:, None, None] + lx[None, :, None]
    pix = torch.stack([gx.expand(n_tiles, tile, tile).reshape(n_tiles, -1),
                       gy.expand(n_tiles, tile, tile).reshape(n_tiles, -1)], dim=-1)
    n_pix = tile * tile

    # 4. fold a z-min over each tile's faces, chunk by chunk; the slots past
    # the fullest tile's list hold no face, so the walk stops there
    zbuf = torch.full((n_tiles, n_pix), float("inf"), device=dev)
    fid = torch.full((n_tiles, n_pix), -1, dtype=torch.long, device=dev)
    bc = torch.zeros((n_tiles, n_pix, 3), device=dev)
    steps = -(-int(kept.max()) // chunk) if n_pairs else 0
    p = pix[:, None]  # (T, 1, P, 2)
    for k0 in range(0, steps * chunk, chunk):
        slot = torch.arange(k0, k0 + chunk, device=dev)
        ok = slot[None, :] < kept[:, None]  # (T, c)
        slot_idx = torch.clamp(start[:, None] + slot[None, :], 0, n_pairs - 1)
        f = torch.where(ok, pair_face[slot_idx], torch.zeros_like(slot_idx))
        v = fv[f]  # (T, c, 3, 2)
        z3 = fz[f]  # (T, c, 3)
        d0 = p - v[:, :, 0, None, :]  # (T, c, P, 2)
        d1 = p - v[:, :, 1, None, :]
        d2 = p - v[:, :, 2, None, :]
        e12 = v[:, :, 2] - v[:, :, 1]  # (T, c, 2)
        e20 = v[:, :, 0] - v[:, :, 2]
        e01 = v[:, :, 1] - v[:, :, 0]
        # edge functions: e0 ~ the signed area of (v1, v2, p)
        e0 = _cross(e12, d1)
        e1 = _cross(e20, d2)
        e2 = _cross(e01, d0)
        area = e0 + e1 + e2
        pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (area > 1e-9)
        neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0) & (area < -1e-9)
        cover = (pos | neg) & ok[..., None]
        inv_a = 1.0 / torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
        b0 = e0 * inv_a
        b1 = e1 * inv_a
        b2 = 1.0 - b0 - b1
        z = _fma(b2, z3[..., 2:3].expand_as(b2),
                 _fma(b0, z3[..., 0:1].expand_as(b0), b1 * z3[..., 1:2]))
        z = torch.where(cover & (z > znear), z, torch.full_like(z, float("inf")))
        zmin, amin = torch.min(z, dim=1)  # the first face of the smallest z
        upd = zmin < zbuf
        a = amin[:, None, :]
        new_fid = torch.gather(f, 1, amin)
        new_b = torch.stack([torch.gather(b, 1, a)[:, 0] for b in (b0, b1, b2)], dim=-1)
        zbuf = torch.where(upd, zmin, zbuf)
        fid = torch.where(upd, new_fid, fid)
        bc = torch.where(upd[..., None], new_b, bc)

    # 5. tiles -> image
    def untile(t, ch=None):
        extra = (ch,) if ch else ()
        t = t.reshape((n_ty, n_tx, tile, tile) + extra).movedim(2, 1)
        return t.reshape((n_ty * tile, n_tx * tile) + extra)[:height, :width]

    face_id = untile(fid)
    zimg = torch.where(face_id >= 0, untile(zbuf), torch.full_like(untile(zbuf), -1.0))
    return TriRasterOut(face_id, untile(bc, 3), zimg, n_dropped_pairs, n_dropped_tile)


def rasterize_triangles_camera(verts, faces, camera, **kw) -> TriRasterOut:
    """``rasterize_triangles`` on the device of ``verts`` with an
    ``ops.camera.Camera``."""
    return rasterize_triangles(
        torch.as_tensor(verts), torch.as_tensor(faces), camera.w2c, camera.full_proj,
        height=camera.height, width=camera.width, znear=float(camera.znear), **kw)
