"""Per-Gaussian view preprocessing: frustum cull, EWA 3D->2D covariance
projection, conic/radius computation, tile-rect extents, SH colour.

Port of the JAX package's ``ops/rasterizer/preprocess.py`` as plain torch
under autograd (the JAX package autodiffs this stage too); ``rasterize``
runs it as kernel K7 with a hand backward (``project.py``), whose twin and
reference it is.  Semantics of
the CUDA ``preprocessCUDA`` stage: view-space cull at z <= 0.2, Jacobian
clamp at 1.3 * tan(fov/2), 0.3-pixel low-pass dilation, radius =
ceil(3 sqrt(max eigenvalue)) with the discriminant clamped at 0.1, and
pix = ((ndc + 1) * size - 1) / 2.  Masked lanes use the double-where
pattern so culled Gaussians cannot poison gradients with NaNs.  Camera
scalars are rounded through float32, as the JAX package computes them."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import Camera
from ..sh import eval_sh_color


def _cov3d_entries(scales, quats, modifier):
    """Upper-triangular entries of Sigma = R diag(s^2) R^T.  The norm is
    summed term by term, as K7 (``csrc/project.cu``) sums it, and clamped
    squared (1e-24 = (1e-12)^2) so that a zero quaternion's gradient is 0."""
    qw, qx, qy, qz = quats.unbind(-1)
    sq = qw * qw + qx * qx + qy * qy + qz * qz
    q = quats / torch.sqrt(torch.clamp_min(sq, 1e-24))[..., None]
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s2 = (modifier * scales) ** 2
    a, b, c = s2.unbind(-1)
    s00 = r00 * r00 * a + r01 * r01 * b + r02 * r02 * c
    s01 = r00 * r10 * a + r01 * r11 * b + r02 * r12 * c
    s02 = r00 * r20 * a + r01 * r21 * b + r02 * r22 * c
    s11 = r10 * r10 * a + r11 * r11 * b + r12 * r12 * c
    s12 = r10 * r20 * a + r11 * r21 * b + r12 * r22 * c
    s22 = r20 * r20 * a + r21 * r21 * b + r22 * r22 * c
    return s00, s01, s02, s11, s12, s22


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance [a, b, c]
    radii: torch.Tensor  # (N,) int32 screen radius, 0 = invisible
    tiles_min: torch.Tensor  # (N, 2) int32 inclusive tile rect min (x, y)
    tiles_max: torch.Tensor  # (N, 2) int32 exclusive tile rect max (x, y)
    visible: torch.Tensor  # (N,) bool


def _f32(x) -> float:
    return float(np.float32(x))


def camera_scalars(camera: Camera):
    """(focal_x, focal_y, lim_x, lim_y) of the EWA Jacobian, rounded through
    float32 as the JAX package computes them."""
    tanfx = np.float32(camera.tanfovx)
    tanfy = np.float32(camera.tanfovy)
    return (_f32(np.float32(camera.width) / (np.float32(2.0) * tanfx)),
            _f32(np.float32(camera.height) / (np.float32(2.0) * tanfy)),
            _f32(np.float32(1.3) * tanfx), _f32(np.float32(1.3) * tanfy))


def project_gaussians(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) activated scales
    quats: torch.Tensor,  # (N, 4) unnormalised wxyz
    camera: Camera,
    tile_size: int,
    scaling_modifier: float = 1.0,
    alive: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> Projected:
    """Project all Gaussians into one camera.

    `means2d_offset` (N, 2), if given, is added to the NDC-scaled screen
    position: the gradient side channel the densifier reads.  Its gradient
    is d(loss)/d(means2d in NDC units), pixel gradients scaled by (W/2, H/2).
    """
    height, width = camera.height, camera.width
    m_x, m_y, m_z = means3d.unbind(-1)
    w2c = camera.w2c

    def _mv3(r):
        return m_x * r[0] + m_y * r[1] + m_z * r[2] + r[3]

    p_view_x = _mv3(w2c[0])
    p_view_y = _mv3(w2c[1])
    depth = _mv3(w2c[2])
    in_frustum = depth > 0.2
    if alive is not None:
        in_frustum = in_frustum & alive
    ones = torch.ones_like(depth)
    safe_depth = torch.where(in_frustum, depth, ones)

    fp = camera.full_proj
    hom_x = _mv3(fp[0])
    hom_y = _mv3(fp[1])
    w_hom = _mv3(fp[3])
    rw = 1.0 / (torch.where(in_frustum, w_hom, ones) + 1e-7)
    ndc_xy = torch.stack([hom_x, hom_y], dim=-1) * rw[..., None]
    sizes = torch.tensor([width, height], dtype=torch.float32, device=means3d.device)
    means2d = ((ndc_xy + 1.0) * sizes - 1.0) * 0.5
    if means2d_offset is not None:
        means2d = means2d + means2d_offset * (sizes * 0.5)

    s00, s01, s02, s11, s12, s22 = _cov3d_entries(scales, quats, scaling_modifier)
    focal_x, focal_y, limx, limy = camera_scalars(camera)
    tx = torch.clamp(p_view_x / safe_depth, -limx, limx) * safe_depth
    ty = torch.clamp(p_view_y / safe_depth, -limy, limy) * safe_depth
    tz = safe_depth

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    rot_w = w2c[:3, :3]
    t0 = j00[..., None] * rot_w[0] + j02[..., None] * rot_w[2]  # (N, 3)
    t1 = j11[..., None] * rot_w[1] + j12[..., None] * rot_w[2]  # (N, 3)

    def sigma_vec(vx, vy, vz):
        return (
            s00 * vx + s01 * vy + s02 * vz,
            s01 * vx + s11 * vy + s12 * vz,
            s02 * vx + s12 * vy + s22 * vz,
        )

    st0 = sigma_vec(t0[..., 0], t0[..., 1], t0[..., 2])
    st1 = sigma_vec(t1[..., 0], t1[..., 1], t1[..., 2])
    c00 = t0[..., 0] * st0[0] + t0[..., 1] * st0[1] + t0[..., 2] * st0[2] + 0.3
    c01 = t1[..., 0] * st0[0] + t1[..., 1] * st0[1] + t1[..., 2] * st0[2]
    c11 = t1[..., 0] * st1[0] + t1[..., 1] * st1[1] + t1[..., 2] * st1[2] + 0.3

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (c00 + c11)
        lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))

        grid_x = (width + tile_size - 1) // tile_size
        grid_y = (height + tile_size - 1) // tile_size
        mx, my = means2d[..., 0], means2d[..., 1]
        x0 = torch.clamp(torch.floor((mx - radius_f) / tile_size), 0, grid_x).int()
        y0 = torch.clamp(torch.floor((my - radius_f) / tile_size), 0, grid_y).int()
        x1 = torch.clamp(
            torch.floor((mx + radius_f + tile_size - 1) / tile_size), 0, grid_x
        ).int()
        y1 = torch.clamp(
            torch.floor((my + radius_f + tile_size - 1) / tile_size), 0, grid_y
        ).int()
        tiles_touched = (x1 - x0) * (y1 - y0)
        visible = in_frustum & det_ok & (radius_f > 0.0) & (tiles_touched > 0)
        radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).int()

    return Projected(
        means2d=means2d,
        depths=depth,
        conics=conic,
        radii=radii,
        tiles_min=torch.stack([x0, y0], dim=-1),
        tiles_max=torch.stack([x1, y1], dim=-1),
        visible=visible,
    )


def sh_colors(
    means3d: torch.Tensor,
    sh_coeffs: torch.Tensor,  # (N, K, 3)
    campos: torch.Tensor,  # (3,)
    degree: int,
) -> torch.Tensor:
    """View-dependent RGB from SH, as the CUDA preprocess does (direction
    from the camera centre to the point, clamped at 0 after the +0.5)."""
    dirs = means3d - campos
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    return eval_sh_color(sh_coeffs, dirs, degree)
