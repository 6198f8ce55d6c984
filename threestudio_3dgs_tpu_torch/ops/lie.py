"""SO(3)/SE(3) Lie-group ops on wxyz quaternions (port of the JAX
package's ``ops/lie.py``).

All ops are batched over leading dims.  At the identity the norms whose
derivative is undefined at zero are taken on a safe input (the double
``where``) and small-angle Taylor branches stand in, with the JAX
package's thresholds, so values and gradients stay finite there."""

from __future__ import annotations

import torch

from . import quaternion

_EPS = 1e-8


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4) wxyz."""
    sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_sq = torch.where(small, 1.0, sq)
    angle = torch.sqrt(safe_sq)
    half = 0.5 * angle
    k_large = torch.sin(half) / angle
    k = torch.where(small, 0.5 - sq / 48.0, k_large)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, phi * k], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> axis-angle (..., 3), |angle| <= pi."""
    q = quaternion.normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)  # the principal branch, w >= 0
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vec = q[..., 1:]
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_sq = torch.where(small, 1.0, sq)
    sin_half = torch.sqrt(safe_sq)
    angle = 2.0 * torch.atan2(sin_half, w)
    k_large = angle / sin_half
    k = torch.where(small, 2.0 / torch.clamp_min(w, _EPS) - 2.0 * sq / 3.0, k_large)
    return vec * k


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) [rho, phi] -> (..., 7) [t, q_wxyz], with the
    left-Jacobian coupling of the translation."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = so3_exp(phi)
    a2_raw = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = a2_raw < 1e-12
    a2 = torch.where(small, 1.0, a2_raw)
    angle = torch.sqrt(a2)
    # V = I + (1 - cos) / a^2 [phi]x + (a - sin a) / a^3 [phi]x^2
    c1 = torch.where(small, 0.5 - a2_raw / 24.0, (1.0 - torch.cos(angle)) / a2)
    c2 = torch.where(small, 1.0 / 6.0 - a2_raw / 120.0, (angle - torch.sin(angle)) / (a2 * angle))
    px = torch.linalg.cross(phi, rho, dim=-1)
    ppx = torch.linalg.cross(phi, px, dim=-1)
    t = rho + c1 * px + c2 * ppx
    return torch.cat([t, q], dim=-1)


def se3_log(tq: torch.Tensor) -> torch.Tensor:
    """(..., 7) [t, q_wxyz] -> twist (..., 6) [rho, phi]."""
    t, q = tq[..., :3], tq[..., 3:]
    phi = so3_log(q)
    a2_raw = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = a2_raw < 1e-12
    a2 = torch.where(small, 1.0, a2_raw)
    angle = torch.sqrt(a2)
    half = 0.5 * angle
    # V^-1 = I - 0.5 [phi]x + (1 / a^2 - cot(a / 2) / (2 a)) [phi]x^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + a2_raw / 720.0,
        (1.0 / a2) - torch.cos(half) / torch.clamp_min(2.0 * angle * torch.sin(half), _EPS),
    )
    px = torch.linalg.cross(phi, t, dim=-1)
    ppx = torch.linalg.cross(phi, px, dim=-1)
    rho = t - 0.5 * px + cot_term * ppx
    return torch.cat([rho, phi], dim=-1)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 7) composition a * b (b first, then a)."""
    ta, qa = a[..., :3], a[..., 3:]
    tb, qb = b[..., :3], b[..., 3:]
    return torch.cat([ta + quaternion.apply(qa, tb), quaternion.multiply(qa, qb)], dim=-1)


def se3_inverse(a: torch.Tensor) -> torch.Tensor:
    t, q = a[..., :3], a[..., 3:]
    qi = quaternion.conjugate(quaternion.normalize(q))
    return torch.cat([-quaternion.apply(qi, t), qi], dim=-1)


def se3_apply(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return quaternion.apply(a[..., 3:], p) + a[..., :3]


def se3_identity(shape=()) -> torch.Tensor:
    base = torch.zeros(tuple(shape) + (7,))
    base[..., 3] = 1.0
    return base
