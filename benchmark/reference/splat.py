"""Plain reference of the 3D Gaussian splatting render, forward and
backward, as the published rasterizer (Kerbl et al. 2023,
diff-gaussian-rasterization) defines it, in float32 under autograd:

  * view-space cull at z <= 0.2; EWA projection of the 3D covariance
    R S S^T R^T through the Jacobian with tx / tz clamped at 1.3 tan(fov/2)
    and a 0.3-pixel dilation; pixel centres at ((ndc + 1) S - 1) / 2;
  * radius ceil(3 sqrt(lambda_max)) (discriminant clamped at 0.1) and the
    square of tiles it covers; a Gaussian reaches only the pixels of those
    tiles;
  * per pixel, front to back in view depth: alpha = min(0.99, o exp(power)),
    skipped where power > 0 or alpha < 1/255, and compositing stops before
    the Gaussian that would take the transmittance below 1e-4;
  * colour from degree-0 spherical harmonics, 0.28209479 f_dc + 0.5,
    clamped at 0; depth the weighted view depth.

The tiles of the published kernel are a schedule, not a result: here every
pixel sees every visible Gaussian of its tile in one dense pass, a block of
pixel rows at a time under activation checkpointing, so the autograd
backward fits at the cells' sizes."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

SH_C0 = 0.28209479177387814
ALPHA_MIN, ALPHA_MAX, T_MIN = 1.0 / 255.0, 0.99, 1e-4


def camera(c2w_gl: np.ndarray, fovy: float, height: int, width: int, device,
           znear: float = 0.1, zfar: float = 100.0) -> Dict[str, torch.Tensor]:
    """World-to-camera (OpenCV axes) and world-to-clip matrices of an
    OpenGL camera-to-world matrix, fov_x = fov_y."""
    c2w = torch.as_tensor(np.asarray(c2w_gl, np.float64))
    c2w = c2w * torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64)[None, :]
    rot_t = c2w[:3, :3].T
    w2c = torch.eye(4, dtype=torch.float64)
    w2c[:3, :3] = rot_t
    w2c[:3, 3] = -rot_t @ c2w[:3, 3]
    tan = math.tan(float(fovy) / 2.0)
    proj = torch.zeros((4, 4), dtype=torch.float64)
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    return {"w2c": w2c.float().to(device), "full": (proj @ w2c).float().to(device),
            "tan": tan, "height": int(height), "width": int(width)}


def covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) R diag(s^2) R^T of activated scales and wxyz quaternions."""
    q = quats / quats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    m = rot * scales[:, None, :]
    return m @ m.transpose(1, 2)


def project(means, scales, quats, cam, tile: int):
    """Screen means, conics, view depths, visibility and tile rectangles."""
    h, w = cam["height"], cam["width"]
    hom = torch.cat([means, torch.ones_like(means[:, :1])], dim=1)
    view = hom @ cam["w2c"].T
    depth = view[:, 2]
    front = depth > 0.2
    safe_z = torch.where(front, depth, torch.ones_like(depth))
    clip = hom @ cam["full"].T
    rw = 1.0 / (torch.where(front, clip[:, 3], torch.ones_like(depth)) + 1e-7)
    size = torch.tensor([w, h], dtype=torch.float32, device=means.device)
    mean2d = ((clip[:, :2] * rw[:, None] + 1.0) * size - 1.0) * 0.5
    tan = cam["tan"]
    fx, fy = w / (2.0 * tan), h / (2.0 * tan)
    lim = 1.3 * tan
    tx = torch.clamp(view[:, 0] / safe_z, -lim, lim) * safe_z
    ty = torch.clamp(view[:, 1] / safe_z, -lim, lim) * safe_z
    zero = torch.zeros_like(safe_z)
    jac = torch.stack([
        torch.stack([fx / safe_z, zero, -fx * tx / safe_z ** 2], -1),
        torch.stack([zero, fy / safe_z, -fy * ty / safe_z ** 2], -1),
    ], dim=1)  # (N, 2, 3)
    t = jac @ cam["w2c"][:3, :3]
    cov2 = t @ covariance(scales, quats) @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det > 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], dim=-1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam))
        gx, gy = (w + tile - 1) // tile, (h + tile - 1) // tile
        mx, my = mean2d[:, 0], mean2d[:, 1]
        x0 = torch.clamp(torch.floor((mx - radius) / tile), 0, gx)
        y0 = torch.clamp(torch.floor((my - radius) / tile), 0, gy)
        x1 = torch.clamp(torch.floor((mx + radius + tile - 1) / tile), 0, gx)
        y1 = torch.clamp(torch.floor((my + radius + tile - 1) / tile), 0, gy)
        visible = front & ok & (radius > 0) & ((x1 - x0) * (y1 - y0) > 0)
    rect = torch.stack([x0, y0, x1, y1], dim=-1)
    return mean2d, conic, depth, visible, rect


def _composite_rows(row0: int, rows: int, width: int, tile: int, mean2d, conic, opac, feats,
                    rect):
    """(rows * width, C + 1): the composited features and the weight sum of
    pixel rows [row0, row0 + rows) over Gaussians already in depth order."""
    dev = mean2d.device
    ys = torch.arange(row0, row0 + rows, device=dev, dtype=torch.float32)
    xs = torch.arange(width, device=dev, dtype=torch.float32)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    tx, ty = torch.floor(px / tile), torch.floor(py / tile)
    covered = (tx >= rect[:, 0]) & (tx < rect[:, 2]) & (ty >= rect[:, 1]) & (ty < rect[:, 3])
    dx = px - mean2d[:, 0]
    dy = py - mean2d[:, 1]
    power = -0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) - conic[:, 1] * dx * dy
    alpha = opac * torch.exp(torch.clamp_max(power, 0.0))
    keep = covered & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, torch.clamp_max(alpha, ALPHA_MAX), torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    weight = torch.where(t_incl.detach() >= T_MIN, alpha * t_excl, torch.zeros_like(alpha))
    return torch.cat([weight @ feats, weight.sum(dim=1, keepdim=True)], dim=1)


def render(means, scales, quats, opacities, colors, cam, tile: int = 32,
           block_rows: int = 16) -> Dict[str, torch.Tensor]:
    """One view: {"image" (H, W, 3) without background, "alpha" (H, W),
    "depth" (H, W)}."""
    mean2d, conic, depth, visible, rect = project(means, scales, quats, cam, tile)
    idx = torch.nonzero(visible).squeeze(1)
    order = idx[torch.argsort(depth[idx], stable=True)]
    feats = torch.cat([colors, depth[:, None]], dim=1)[order]
    args = (mean2d[order], conic[order], opacities[order], feats, rect[order])
    h, w = cam["height"], cam["width"]
    rows = [checkpoint(_composite_rows, r, min(block_rows, h - r), w, tile, *args,
                       use_reentrant=False)
            for r in range(0, h, block_rows)]
    out = torch.cat(rows).reshape(h, w, -1)
    return {"image": out[..., :3], "depth": out[..., 3], "alpha": out[..., 4]}


def sh0_colors(features_dc: torch.Tensor) -> torch.Tensor:
    """Degree-0 colour of (N, 1, 3) coefficients."""
    return torch.clamp_min(SH_C0 * features_dc[:, 0] + 0.5, 0.0)


def sphere_init(n: int, radius: float, opacity: float, seed: int) -> Dict[str, np.ndarray]:
    """threestudio-3dgs's random init: n points uniform in a ball (numpy's
    generator from ``seed``: angles, cos(theta), radius^3, then colours),
    isotropic scales from the mean squared distance to the 3 nearest
    neighbours, identity rotations and a constant opacity."""
    rng = np.random.default_rng(seed)
    phis = rng.random(n) * 2 * np.pi
    thetas = np.arccos(rng.random(n) * 2 - 1)
    r = radius * np.cbrt(rng.random(n))
    xyz = np.stack([r * np.sin(thetas) * np.cos(phis), r * np.sin(thetas) * np.sin(phis),
                    r * np.cos(thetas)], axis=1).astype(np.float32)
    shs = rng.random((n, 3)).astype(np.float32) / 255.0
    rgb = shs * np.float32(SH_C0) + np.float32(0.5)
    pts = torch.as_tensor(xyz, dtype=torch.float64)
    d2 = []
    for i in range(0, n, 2048):
        dist = torch.cdist(pts[i:i + 2048], pts) ** 2
        dist[torch.arange(dist.shape[0]), torch.arange(i, i + dist.shape[0])] = float("inf")
        d2.append(torch.topk(dist, 3, largest=False).values.mean(dim=1))
    d2 = np.maximum(torch.cat(d2).numpy(), 1e-7)
    scale = np.log(np.sqrt(d2)).astype(np.float32)
    return {
        "xyz": xyz,
        "features_dc": ((rgb - np.float32(0.5)) / np.float32(SH_C0)).astype(np.float32)[:, None],
        "scaling": np.repeat(scale[:, None], 3, axis=1),
        "rotation": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "opacity": np.full((n, 1), np.log(opacity / (1 - opacity)), np.float32),
    }


def image_shape(batch) -> Tuple[int, int]:
    return int(batch["height"]), int(batch["width"])
