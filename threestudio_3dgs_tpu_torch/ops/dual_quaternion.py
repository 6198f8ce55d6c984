"""Dual-quaternion algebra in torch (wxyz real part; port of the JAX
package's ``ops/dual_quaternion.py``).

A dual quaternion is the pair (q_r, q_d) stored as (..., 8); the rigid
transform (q, t) maps to q_r = q, q_d = 0.5 t_quat q.  Dynamic SuGaR's
dual-quaternion skinning (DQS) blends the nodes' transforms with
``blend``."""

from __future__ import annotations

from typing import Tuple

import torch

from . import quaternion


def from_quat_translation(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4), (..., 3) -> (..., 8) [q_r | q_d]."""
    q = quaternion.normalize(q)
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return torch.cat([q, 0.5 * quaternion.multiply(t_quat, q)], dim=-1)


def real(dq: torch.Tensor) -> torch.Tensor:
    return dq[..., :4]


def dual(dq: torch.Tensor) -> torch.Tensor:
    return dq[..., 4:]


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    qr = quaternion.multiply(real(a), real(b))
    qd = quaternion.multiply(real(a), dual(b)) + quaternion.multiply(dual(a), real(b))
    return torch.cat([qr, qd], dim=-1)


def conjugate(dq: torch.Tensor) -> torch.Tensor:
    return torch.cat([quaternion.conjugate(real(dq)), quaternion.conjugate(dual(dq))], dim=-1)


def normalize(dq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """|q_r| = 1 (divided by max(|q_r|, eps)) and <q_r, q_d> = 0 (the part of
    q_d along q_r removed)."""
    norm = torch.clamp_min(torch.linalg.norm(real(dq), dim=-1, keepdim=True), eps)
    qr = real(dq) / norm
    qd = dual(dq) / norm
    qd = qd - torch.sum(qr * qd, dim=-1, keepdim=True) * qr
    return torch.cat([qr, qd], dim=-1)


def to_quat_translation(dq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    qr = real(dq)
    t_quat = 2.0 * quaternion.multiply(dual(dq), quaternion.conjugate(qr))
    return qr, t_quat[..., 1:]


def transform_point(dq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The rigid transform of a unit dual quaternion applied to p."""
    q, t = to_quat_translation(dq)
    return quaternion.apply(q, p) + t


def blend(dqs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion linear blending over axis -2: each (..., K, 8) dual
    quaternion flipped onto the hemisphere of the first (a zero dot product
    counts as +1), weighted by (..., K), summed and normalised."""
    pivot = dqs[..., 0:1, :4]
    sign = torch.sign(torch.sum(dqs[..., :4] * pivot, dim=-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return normalize(torch.sum(dqs * sign * weights[..., None], dim=-2))
