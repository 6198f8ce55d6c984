"""Textured-mesh extraction for SuGaR, the ``--predict`` path (port of the
JAX package's ``models/texture_bake.py``).

  * ``build_triangle_uv_atlas`` -- faces 2k and 2k+1 share texel square k,
    their triangles inset from the square's border;
  * ``init_texture_from_sh`` -- each texel of a face's square takes the SH
    DC colour of the face's Gaussian densest at the texel's 3D point (on
    the device, chunked by faces);
  * ``bake_texture_uv`` -- per view, the triangle id-pass of
    ``ops/tri_raster.py`` gives each pixel a face and barycentrics, its UV
    names a texel, and the rendered colours are averaged into the texels in
    float64 on the device; texels no view sees keep the initial texture;
  * ``save_textured_obj_uv`` -- OBJ with three UVs a face, MTL and PNG;
  * ``method="points"`` (taken when ``square_size < 6``): one flat colour
    per Gaussian square from the centres' projections
    (``build_point_uv_atlas``, ``project_points``, ``bake_texture``,
    ``save_textured_obj``).

The OBJ and MTL bytes equal the JAX package's (the same ``{:.6f}`` rows in
the same order, formatted in one pass over all rows); the PNG goes through
the port's own encoder (``utils/saving.py``), with the pixels imageio is
given in the JAX package.  Sums that numpy takes in the JAX package are
taken here in numpy's order (its einsums over three terms add them left to
right), so texels agree exactly away from ties of density."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.saving import encode_png


# ---------------------------------------------------------------------------
# Per-texel UV bake
# ---------------------------------------------------------------------------


def build_triangle_uv_atlas(n_faces: int, square_size: int = 10):
    """Faces 2k (bottom) and 2k+1 (top) share texel square k; triangle
    corners are inset from the square's border so nearest sampling never
    bleeds across faces.  Returns (tex_size, verts_uv (F, 3, 2) float32 in
    texel coordinates (a = column, b = row)); the OBJ's vt is
    (a / tex, 1 - b / tex)."""
    ss = square_size
    n_squares = n_faces // 2 + 1
    n_axis = int(np.sqrt(n_squares) + 1)
    tex_size = ss * n_axis
    sq = np.arange(n_faces) // 2
    top = (np.arange(n_faces) % 2).astype(bool)
    origin = np.stack([sq % n_axis, sq // n_axis], axis=1) * ss  # (F, 2) (a, b)
    bottom_local = np.array([[ss - 2, 1], [2, 1], [ss - 2, ss - 3]], np.float32)
    top_local = np.array([[1, ss - 1], [1, 3], [ss - 3, ss - 1]], np.float32)
    local = np.where(top[:, None, None], top_local[None], bottom_local[None])
    verts_uv = origin[:, None, :].astype(np.float32) + local
    return tex_size, verts_uv


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _uv_bary(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Signed barycentrics of points p (..., 2) in triangles tri (..., 3, 2)."""
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    area = _cross2(v1 - v0, v2 - v0)
    inv = 1.0 / torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
    b0 = _cross2(v2 - v1, p - v1) * inv
    b1 = _cross2(v0 - v2, p - v2) * inv
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def _sum3(terms) -> torch.Tensor:
    """numpy's order for a three-term einsum or sum: (t0 + t1) + t2."""
    return (terms[0] + terms[1]) + terms[2]


@torch.no_grad()
def init_texture_from_sh(
    verts: torch.Tensor,  # (V, 3)
    faces: torch.Tensor,  # (F, 3)
    verts_uv: torch.Tensor,  # (F, 3, 2) texel coordinates
    tex_size: int,
    square_size: int,
    gauss_xyz: torch.Tensor,  # (F*G, 3) per-face Gaussian centres
    gauss_inv_rot: torch.Tensor,  # (F*G, 3, 3) R diag(1/s)
    gauss_rgb: torch.Tensor,  # (F*G, 3) colours of the SH DC terms
    chunk: int = 16384,
) -> torch.Tensor:
    """(tex, tex, 3) f32 on the device of ``verts``: every texel of a face
    pair's square gets the colour of the densest Gaussian, at the texel's
    3D point, of the face whose triangle the texel is least outside of (the
    JAX package fills the gutter texels too).  Where both faces of a square
    are equally near, the odd face's colour is written, as the JAX package's
    numpy assignment leaves it."""
    dev = verts.device
    ss = square_size
    n_faces = faces.shape[0]
    n_g = gauss_xyz.shape[0] // n_faces
    faces = faces.long()
    texture = torch.full((tex_size, tex_size, 3), 0.5, device=dev)
    jj, ii = torch.meshgrid(torch.arange(ss, device=dev), torch.arange(ss, device=dev),
                            indexing="ij")
    # texel centres of one square, (ss * ss, 2) as (a, b) = (column, row)
    local_px = torch.stack([ii + 0.5, jj + 0.5], dim=-1).reshape(-1, 2).float()
    for f0 in range(0, n_faces, chunk):
        fc = torch.arange(f0, min(f0 + chunk, n_faces), device=dev)
        uv = verts_uv[fc]  # (C, 3, 2)
        sq_origin = torch.div(uv.amin(dim=1), ss, rounding_mode="floor") * ss
        px = sq_origin[:, None, :] + local_px[None]  # (C, P, 2)
        bary = _uv_bary(px, uv[:, None])  # (C, P, 3)
        partner = fc ^ 1
        has_partner = partner < n_faces
        partner = torch.where(has_partner, partner, fc)
        bary_p = _uv_bary(px, verts_uv[partner][:, None])
        bmin, pmin = bary.amin(dim=-1), bary_p.amin(dim=-1)
        # one writer per texel: the even face on a strict win, the odd face
        # on a tie too, a face without a partner everywhere
        odd = (fc % 2 == 1)[:, None]
        mine = torch.where(odd, bmin >= pmin, bmin > pmin) | ~has_partner[:, None]
        bary_cl = torch.clamp_min(bary, 0.0)
        bary_cl = bary_cl / torch.clamp_min(_sum3(bary_cl.unbind(-1)), 1e-8)[..., None]
        fverts = verts[faces[fc]]  # (C, 3, 3)
        pos = _sum3([bary_cl[..., k, None] * fverts[:, None, k] for k in range(3)])  # (C, P, 3)
        g_idx = fc[:, None] * n_g + torch.arange(n_g, device=dev)[None]  # (C, G)
        shift = pos[:, :, None, :] - gauss_xyz[g_idx][:, None]  # (C, P, G, 3)
        inv_rot = gauss_inv_rot[g_idx][:, None]  # (C, 1, G, 3, 3)
        warped = _sum3([inv_rot[..., x, :] * shift[..., x, None] for x in range(3)])
        sq_norm = _sum3([warped[..., y] ** 2 for y in range(3)])
        dens = torch.exp(-0.5 * torch.clamp(sq_norm, 0.0, 1e8))  # (C, P, G)
        best = dens.argmax(dim=-1)  # the first of the densest
        color = gauss_rgb[torch.gather(g_idx[:, None, :].expand(-1, best.shape[1], -1), 2,
                                       best[..., None])[..., 0]]
        a = torch.clamp(px[..., 0].long(), 0, tex_size - 1)
        b = torch.clamp(px[..., 1].long(), 0, tex_size - 1)
        texture[b[mine], a[mine]] = color[mine]
    return texture


@torch.no_grad()
def bake_texture_uv(
    verts: torch.Tensor,
    faces: torch.Tensor,
    verts_uv: torch.Tensor,  # (F, 3, 2) texel coordinates
    tex_size: int,
    renders: List[Dict],  # per view: {"rgb" (H, W, 3), "camera"}
    init_texture: Optional[torch.Tensor] = None,
    stats: Optional[Dict] = None,
) -> torch.Tensor:
    """Per-texel bake on the device of ``verts``: a triangle id-pass per
    view, each hit pixel's colour averaged into the texel its UV names
    (float64 sums); texels no view sees keep ``init_texture``.  ``stats``,
    where given, collects each view's drop counters, the share of texels
    seen and the wall seconds of the id-passes and the scatters."""
    from ..ops.tri_raster import rasterize_triangles_camera

    dev = verts.device
    n_faces = faces.shape[0]
    max_pairs = max(1 << 18, 1 << int(np.ceil(np.log2(max(6 * n_faces, 2)))))
    accum = torch.zeros((tex_size * tex_size, 3), dtype=torch.float64, device=dev)
    count = torch.zeros((tex_size * tex_size,), dtype=torch.int64, device=dev)
    clock = {"id_pass_s": 0.0, "scatter_s": 0.0}

    def tick(key, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock[key] += time.perf_counter() - t0
        return time.perf_counter()

    for view in renders:
        t0 = time.perf_counter()
        out = rasterize_triangles_camera(verts, faces, view["camera"], max_pairs=max_pairs,
                                         max_faces_per_tile=1024)
        t0 = tick("id_pass_s", t0)
        if stats is not None:
            stats.setdefault("n_dropped_pairs", []).append(int(out.n_dropped_pairs))
            stats.setdefault("n_dropped_tile", []).append(int(out.n_dropped_tile))
        rgb = torch.as_tensor(np.asarray(view["rgb"]), device=dev)
        hit = out.face_id >= 0
        f_hit = out.face_id[hit]
        bary = out.bary[hit]  # (Ph, 3)
        tri_uv = verts_uv[f_hit]  # (Ph, 3, 2)
        uv = _sum3([bary[:, k, None] * tri_uv[:, k] for k in range(3)])
        a = torch.clamp(torch.floor(uv[:, 0]).long(), 0, tex_size - 1)
        b = torch.clamp(torch.floor(uv[:, 1]).long(), 0, tex_size - 1)
        texel = b * tex_size + a
        accum.index_put_((texel,), rgb[hit].double(), accumulate=True)
        count.index_put_((texel,), torch.ones_like(texel), accumulate=True)
        tick("scatter_s", t0)
    baked = (accum / torch.clamp_min(count, 1)[:, None]).float().reshape(tex_size, tex_size, 3)
    seen = (count > 0).reshape(tex_size, tex_size)
    if init_texture is None:
        init_texture = torch.full((tex_size, tex_size, 3), 0.5, device=dev)
    if stats is not None:
        stats.update(clock)
        stats["texels_seen"] = float(seen.float().mean())
    return torch.where(seen[..., None], baked, init_texture)


def _write_png(path: str, texture) -> None:
    img = (np.clip(np.asarray(texture, np.float32), 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _write_mtl(base: str) -> None:
    with open(base + ".mtl", "w") as f:
        f.write(f"newmtl baked\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n"
                f"map_Kd {os.path.basename(base)}.png\n")


def _rows(fmt: str, table: np.ndarray) -> str:
    """``fmt`` applied to every row of ``table`` (one % pass over all of
    them); float32 values format as the Python floats they equal."""
    if len(table) == 0:
        return ""
    return (fmt * len(table)) % tuple(table.ravel().tolist())


def _obj_head(path: str, verts: np.ndarray) -> str:
    base = os.path.splitext(path)[0]
    return (f"mtllib {os.path.basename(base)}.mtl\nusemtl baked\n"
            + _rows("v %.6f %.6f %.6f\n", np.asarray(verts, np.float32).reshape(-1, 3)))


def save_textured_obj_uv(
    path: str,
    verts,
    faces,
    verts_uv,  # (F, 3, 2) texel coordinates
    tex_size: int,
    texture,
) -> str:
    """OBJ + MTL + PNG with three UVs a face: vt = (a / tex, 1 - b / tex),
    the PNG's row 0 at b = 0."""
    verts, faces, verts_uv, texture = (
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in (verts, faces, verts_uv, texture))
    base = os.path.splitext(path)[0]
    _write_png(base + ".png", texture)
    _write_mtl(base)
    uv = (np.asarray(verts_uv, np.float32).reshape(-1, 2) / np.float32(tex_size)).astype(np.float32)
    vt = np.stack([uv[:, 0], (np.float32(1.0) - uv[:, 1]).astype(np.float32)], axis=1)
    f = np.asarray(faces, np.int64) + 1
    t = 3 * np.arange(len(f), dtype=np.int64)[:, None] + np.arange(1, 4)[None]
    ft = np.stack([f, t], axis=-1).reshape(-1, 6)
    with open(path, "w") as fh:
        fh.write(_obj_head(path, verts))
        fh.write(_rows("vt %.6f %.6f\n", vt))
        fh.write(_rows("f %d/%d %d/%d %d/%d\n", ft))
    return path


# ---------------------------------------------------------------------------
# Centre-projection bake (method="points")
# ---------------------------------------------------------------------------


def build_point_uv_atlas(n_points: int, square_size: int = 10):
    """Per-point texel squares in a near-square grid.  Returns (tex_size,
    uv_centers (N, 2) in [0, 1], square origins (N, 2) in pixels)."""
    n_sq = int(np.ceil(np.sqrt(n_points)))
    tex_size = n_sq * square_size
    idx = np.arange(n_points)
    origin = np.stack([idx % n_sq, idx // n_sq], axis=1) * square_size
    centers = (origin + square_size / 2.0) / tex_size
    return tex_size, centers.astype(np.float32), origin.astype(np.int32)


def project_points(points: torch.Tensor, camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates (N, 2) and view depth (N,) of world points under a
    ``Camera``, on the points' device."""
    w2c = camera.w2c.to(points.device)
    proj = camera.full_proj.to(points.device)
    p_view = points @ w2c[:3, :3].T + w2c[:3, 3]
    p_hom = points @ proj[:3, :3].T + proj[:3, 3]
    w_hom = points @ proj[3, :3] + proj[3, 3]
    ndc = p_hom[:, :2] / torch.clamp_min(w_hom[:, None], 1e-6)
    px = ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5
    return torch.stack([px, py], dim=1), p_view[:, 2]


@torch.no_grad()
def bake_texture(
    gauss_xyz: torch.Tensor,  # (Ng, 3)
    gauss_normals: torch.Tensor,  # (Ng, 3)
    renders: List[Dict],  # per view: {"rgb" (H, W, 3), "depth" (H, W) or None, "camera"}
    square_size: int = 10,
    depth_tol: float = 0.05,
):
    """Each Gaussian's square takes the mean colour of the views that see
    its centre in front of them, facing it and not occluded (against the
    rendered depth).  Returns (texture (T, T, 3) f32 on the device,
    uv_centers (Ng, 2))."""
    dev = gauss_xyz.device
    n = gauss_xyz.shape[0]
    tex_size, uv_centers, _ = build_point_uv_atlas(n, square_size)
    accum = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    count = torch.zeros((n, 1), dtype=torch.float64, device=dev)
    for view in renders:
        cam = view["camera"]
        rgb = torch.as_tensor(np.asarray(view["rgb"]), device=dev)
        pix, z = project_points(gauss_xyz, cam)
        xi = torch.round(pix[:, 0]).long()
        yi = torch.round(pix[:, 1]).long()
        ok = (z > 0.2) & (xi >= 0) & (xi < cam.width) & (yi >= 0) & (yi < cam.height)
        view_dir = cam.campos.to(dev)[None] - gauss_xyz
        ok &= torch.sum(view_dir * gauss_normals, dim=-1) > 0  # front-facing only
        xi_c = torch.clamp(xi, 0, cam.width - 1)
        yi_c = torch.clamp(yi, 0, cam.height - 1)
        if view.get("depth") is not None:
            surf = torch.as_tensor(np.asarray(view["depth"]), device=dev)[yi_c, xi_c]
            ok &= torch.abs(z - surf) < depth_tol * torch.clamp_min(z, 1.0)
        colors = rgb[yi_c, xi_c].double()
        accum += torch.where(ok[:, None], colors, torch.zeros_like(colors))
        count += ok[:, None].double()
    point_colors = torch.where(count > 0, accum / torch.clamp_min(count, 1.0),
                               torch.full_like(accum, 0.5)).float()
    # square i at (row i // n_sq, column i % n_sq): a grid of per-square
    # colours grown to square_size pixels a side
    n_sq = tex_size // square_size
    grid = torch.full((n_sq * n_sq, 3), 0.5, device=dev)
    grid[:n] = point_colors
    grid = grid.reshape(n_sq, n_sq, 3)
    texture = grid.repeat_interleave(square_size, 0).repeat_interleave(square_size, 1)
    return texture, uv_centers


def save_textured_obj(
    path: str,
    verts,
    faces,
    face_gauss_idx,  # (F,) the index of a Gaussian per face
    uv_centers,
    texture,
) -> str:
    """OBJ + MTL + PNG: each face takes its Gaussian's square (one UV a
    face)."""
    verts, faces, texture = (
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in (verts, faces, texture))
    base = os.path.splitext(path)[0]
    _write_png(base + ".png", texture)
    _write_mtl(base)
    uvc = np.asarray(uv_centers, np.float32)[np.asarray(face_gauss_idx)]
    vt = np.stack([uvc[:, 0], (np.float32(1.0) - uvc[:, 1]).astype(np.float32)], axis=1)
    f = np.asarray(faces, np.int64) + 1
    t = np.arange(1, len(f) + 1, dtype=np.int64)[:, None].repeat(3, 1)
    ft = np.stack([f, t], axis=-1).reshape(-1, 6)
    with open(path, "w") as fh:
        fh.write(_obj_head(path, verts))
        fh.write(_rows("vt %.6f %.6f\n", vt))
        fh.write(_rows("f %d/%d %d/%d %d/%d\n", ft))
    return path


@torch.no_grad()
def extract_textured_mesh(
    sugar_model,
    sugar_state,
    render_views_fn,
    views: List[Dict],
    out_path: str,
    square_size: int = 10,
    method: str = "uv",
    stats: Optional[Dict] = None,
) -> str:
    """The whole predict path: render the views, bake, save.  ``method="uv"``
    bakes per texel through the triangle id-pass; ``"points"`` (or a square
    under 6 texels) one flat colour per Gaussian square.  ``stats``, where
    given, collects the wall seconds of each stage (renders, id-passes,
    texel init, scatters, file writes), the drop counters and the share of
    texels seen."""
    from ..ops import quaternion
    from ..ops.camera import camera_from_c2w
    from ..ops.sh import sh_to_rgb

    dev = sugar_state.params.points.device
    clock = stats if stats is not None else {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    arrays = sugar_model.as_gaussian_arrays(sugar_state)
    renders = []
    for view, out in zip(views, render_views_fn(views)):
        fovy = float(np.asarray(view["fovy"]).reshape(-1)[0])
        cam = camera_from_c2w(np.asarray(view["c2w"][0]), fovy, fovy, int(view["height"]),
                              int(view["width"]), device=dev)
        renders.append({
            "rgb": out["comp_rgb"][0],
            "depth": out["comp_depth"][0, :, :, 0] if "comp_depth" in out else None,
            "camera": cam,
        })
    t1 = sync()
    clock["render_s"] = t1 - t0
    verts = sugar_state.params.points
    faces = sugar_state.faces

    if method == "points" or square_size < 6:
        texture, uv_centers = bake_texture(arrays["means3d"], arrays["normals"], renders,
                                           square_size)
        t2 = sync()
        clock["bake_s"] = t2 - t1
        face_gauss_idx = np.arange(faces.shape[0]) * sugar_model.n_per_face
        path = save_textured_obj(out_path, verts, faces, face_gauss_idx, uv_centers, texture)
        clock["write_s"] = time.perf_counter() - t2
        return path

    tex_size, verts_uv_np = build_triangle_uv_atlas(faces.shape[0], square_size)
    verts_uv = torch.as_tensor(verts_uv_np, device=dev)
    scales = arrays["scales"]  # (Ng, 3), activated
    rot = quaternion.to_rotation_matrix(arrays["quats"])
    inv_rot = rot / torch.clamp_min(scales[:, None, :], 1e-12)  # R diag(1 / s)
    rgb_dc = torch.clamp(sh_to_rgb(arrays["sh_coeffs"][:, 0]), 0.0, 1.0)
    init_tex = init_texture_from_sh(verts, faces, verts_uv, tex_size, square_size,
                                    arrays["means3d"], inv_rot, rgb_dc)
    t2 = sync()
    clock["texel_init_s"] = t2 - t1
    texture = bake_texture_uv(verts, faces, verts_uv, tex_size, renders, init_tex, stats=clock)
    t3 = sync()
    path = save_textured_obj_uv(out_path, verts, faces, verts_uv_np, tex_size, texture)
    clock["write_s"] = time.perf_counter() - t3
    clock["tex_size"] = tex_size
    return path
