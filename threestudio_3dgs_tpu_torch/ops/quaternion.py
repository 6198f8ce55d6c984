"""Quaternion helpers in torch (wxyz convention, batched, differentiable).

Port of the JAX package's ``ops/quaternion.py``: normalisation, the
rotation matrix and back (SuGaR's face frames), and the Hamilton product,
conjugate and vector rotation the Lie-group and spline ops use."""

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


def from_rotation_matrix(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion: the four
    candidate constructions, the best conditioned one picked by the trace
    and the dominant diagonal element, then normalised."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, eps))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    cand0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                         (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    cand1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                         (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    cand2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                         (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    cand3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                         (m12 + m21) / (4 * qz3), qz3], dim=-1)
    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, cand0, torch.where(use1, cand1, torch.where(use2, cand2, cand3)))
    return normalize(q)
