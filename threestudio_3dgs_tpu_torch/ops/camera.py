"""Camera math (port of the JAX package's ``ops/camera.py``): the
rasterizer's ``Camera`` and ``camera_from_c2w``, field-of-view / focal
conversions, camera-space ray directions, world-space rays and the
model-view-projection matrix.

Conventions as in the JAX package: the data-side ``c2w`` is OpenGL-style
(camera looks along -z, y up); ``Camera.w2c`` is OpenCV (x right, y down,
z forward); ``full_proj = proj @ w2c`` maps world points to clip space and
pixel centres sit at pix = ((ndc + 1) * S - 1) / 2.  The 4x4 matrices are
built in float32 on the CPU and then moved to the camera's device."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def fov_to_focal(fov, pixels: float) -> torch.Tensor:
    return pixels / (2.0 * torch.tan(torch.as_tensor(fov) / 2.0))


def focal_to_fov(focal, pixels: float) -> torch.Tensor:
    return 2.0 * torch.atan(pixels / (2.0 * torch.as_tensor(focal)))


@dataclasses.dataclass
class Camera:
    """One pinhole camera; tensor fields live on the render device."""

    w2c: torch.Tensor  # (4, 4) world -> camera, OpenCV convention
    full_proj: torch.Tensor  # (4, 4) world -> clip
    campos: torch.Tensor  # (3,) camera centre in world space
    tanfovx: float
    tanfovy: float
    znear: float = 0.1
    zfar: float = 100.0
    height: int = 512
    width: int = 512


def projection_matrix(znear: float, zfar: float, tan_x: torch.Tensor,
                      tan_y: torch.Tensor) -> torch.Tensor:
    """Perspective projection (row-major, OpenCV view space: z forward)."""
    proj = torch.zeros((4, 4), dtype=torch.float32)
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    return proj


def convert_gl_to_cv(c2w: torch.Tensor) -> torch.Tensor:
    """Flip the y and z camera axes: OpenGL (look -z) -> OpenCV (look +z)."""
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=c2w.dtype, device=c2w.device)
    return c2w * flip[None, :]


def invert_rigid(mat: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform exactly (R^T, -R^T t)."""
    rot_t = mat[:3, :3].T
    out = torch.zeros_like(mat)
    out[:3, :3] = rot_t
    out[:3, 3] = -rot_t @ mat[:3, 3]
    out[3, 3] = 1.0
    return out


def camera_from_c2w(
    c2w,
    fovx: float,
    fovy: float,
    height: int,
    width: int,
    znear: float = 0.1,
    zfar: float = 100.0,
    device="cuda",
) -> Camera:
    """Build a rasterization camera from an OpenGL-convention c2w matrix."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32))
    tan_x = torch.tan(torch.tensor(float(fovx), dtype=torch.float32) / 2.0)
    tan_y = torch.tan(torch.tensor(float(fovy), dtype=torch.float32) / 2.0)
    c2w_cv = convert_gl_to_cv(c2w)
    w2c = invert_rigid(c2w_cv)
    full_proj = projection_matrix(znear, zfar, tan_x, tan_y) @ w2c
    return Camera(
        w2c=w2c.to(device),
        full_proj=full_proj.to(device),
        campos=c2w_cv[:3, 3].clone().to(device),
        tanfovx=float(tan_x),
        tanfovy=float(tan_y),
        znear=znear,
        zfar=zfar,
        height=int(height),
        width=int(width),
    )


def get_ray_directions(height: int, width: int, fovy, use_pixel_center: bool = True,
                       device="cuda") -> torch.Tensor:
    """Camera-space ray directions (H, W, 3), OpenGL convention (-z
    forward), through the pixel centres with ``use_pixel_center``."""
    focal = 0.5 * height / torch.tan(0.5 * torch.as_tensor(fovy, dtype=torch.float32,
                                                           device=device))
    offset = 0.5 if use_pixel_center else 0.0
    xs = torch.arange(width, dtype=torch.float32, device=device) + offset
    ys = torch.arange(height, dtype=torch.float32, device=device) + offset
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack(
        [(grid_x - width * 0.5) / focal, -(grid_y - height * 0.5) / focal,
         -torch.ones_like(grid_x)],
        dim=-1,
    )


def get_rays(directions: torch.Tensor, c2w: torch.Tensor, keepdim: bool = True,
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space ray origins and directions: ``directions`` (..., 3)
    rotated by a c2w (4, 4), or directions (B, ..., 3) by c2w (B, 4, 4);
    (N, 3) each without ``keepdim``."""
    if c2w.ndim == 2:
        rays_d = torch.einsum("...c,rc->...r", directions, c2w[:3, :3])
        origins = c2w[:3, 3]
    else:
        rays_d = torch.einsum("b...c,brc->b...r", directions, c2w[:, :3, :3])
        origins = c2w[:, :3, 3].reshape((c2w.shape[0],) + (1,) * (rays_d.ndim - 2) + (3,))
    if normalize:
        rays_d = rays_d / torch.clamp_min(torch.linalg.norm(rays_d, dim=-1, keepdim=True), 1e-12)
    rays_o = torch.broadcast_to(origins, rays_d.shape)
    if not keepdim:
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
    return rays_o, rays_d


def get_mvp_matrix(c2w: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Model-view-projection from an OpenGL c2w (4, 4) and a projection
    matrix."""
    return proj @ invert_rigid(convert_gl_to_cv(c2w))
