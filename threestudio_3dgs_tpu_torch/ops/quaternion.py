"""Quaternion helpers in torch (wxyz convention, batched, differentiable).

Port of the JAX package's ``ops/quaternion.py``: normalisation, the
rotation matrix, and the Hamilton product, conjugate and vector rotation
the Lie-group and spline ops use."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Gradient-safe: an all-zero quaternion returns zero with finite (zero)
    gradients instead of 0/0 NaNs."""
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    is_zero = sq < eps * eps
    safe_sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(q), q * torch.rsqrt(safe_sq))


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix (normalises
    first)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)
