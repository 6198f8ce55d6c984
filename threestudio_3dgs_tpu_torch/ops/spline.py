"""SE(3) B-spline trajectories (cubic and linear), port of the JAX
package's ``ops/spline.py``.

Translations interpolate as a basis-weighted sum; rotations use the
cumulative form q(u) = q0 * Exp(c1 Log(q0^-1 q1)) * Exp(c2 Log(q1^-1 q2))
* Exp(c3 Log(q2^-1 q3)) with the cumulative cubic basis.  The timing is the
spacetime setup's: sampling interval 1 / (K - 3), start time -interval,
lookups clamped so each owns a full 4-knot segment."""

from __future__ import annotations

from typing import Tuple

import torch

from . import quaternion
from .lie import so3_exp, so3_log

_EPS = 1e-6


def cubic_coeffs(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coeffs_t (..., 4), coeffs_r (..., 3)) for u in [0, 1]."""
    uu = u * u
    uuu = uu * u
    oos = 1.0 / 6.0
    ct = torch.stack([
        oos - 0.5 * u + 0.5 * uu - oos * uuu,
        4.0 * oos - uu + 0.5 * uuu,
        oos + 0.5 * u + 0.5 * uu - 0.5 * uuu,
        oos * uuu,
    ], dim=-1)
    cr = torch.stack([
        5.0 * oos + 0.5 * u - 0.5 * uu + oos * uuu,
        oos + 0.5 * u + 0.5 * uu - 2.0 * oos * uuu,
        oos * uuu,
    ], dim=-1)
    return ct, cr


def cubic_bspline_interpolation(ctrl_xyz: torch.Tensor, ctrl_quat: torch.Tensor,
                                u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segment: ctrl_xyz (..., 4, 3), ctrl_quat (..., 4, 4) unit wxyz,
    u (...,) in [0, 1]."""
    u = torch.clamp(u, _EPS, 1.0 - _EPS)
    ct, cr = cubic_coeffs(u)
    xyz = torch.sum(ct[..., None] * ctrl_xyz, dim=-2)
    q = ctrl_quat
    q_rel = quaternion.multiply(quaternion.conjugate(q[..., :-1, :]), q[..., 1:, :])
    q_steps = so3_exp(cr[..., None] * so3_log(q_rel))  # (..., 3, 4)
    out_q = q[..., 0, :]
    for k in range(3):
        out_q = quaternion.multiply(out_q, q_steps[..., k, :])
    return xyz, quaternion.normalize(out_q)


def linear_interpolation(ctrl_xyz: torch.Tensor, ctrl_quat: torch.Tensor,
                         u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    u1 = u[..., None]
    xyz = (1.0 - u1) * ctrl_xyz[..., 0, :] + u1 * ctrl_xyz[..., 1, :]
    q_rel = quaternion.multiply(quaternion.conjugate(ctrl_quat[..., 0, :]), ctrl_quat[..., 1, :])
    q = quaternion.multiply(ctrl_quat[..., 0, :], so3_exp(u1 * so3_log(q_rel)))
    return xyz, quaternion.normalize(q)


def spline_timing(n_knots: int, degree: int = 3):
    """(interval, start_time, t_lower, t_upper): interval = 1 / (n - 3) and
    start = -interval for the cubic, so [0, 1] maps to interior segments."""
    if degree == 3:
        interval = 1.0 / (n_knots - 3)
        start = -interval
        return interval, start, start + interval, start + (n_knots - 2) * interval
    interval = 1.0 / (n_knots - 1)
    return interval, 0.0, 0.0, (n_knots - 1) * interval


def _segments(knots: torch.Tensor, t, degree: int):
    """The knots of each point's segment (N, order, C) and the segment
    parameter u (N,) at spline time ``t`` (a scalar or (N,))."""
    n, k = knots.shape[0], knots.shape[1]
    order = degree + 1
    interval, start, t_low, t_up = spline_timing(k, degree)
    tt = torch.clamp(torch.as_tensor(t, dtype=torch.float32, device=knots.device),
                     t_low + _EPS, t_up - _EPS)
    normalized = (tt - start) / interval
    idx = torch.floor(normalized).to(torch.int32)
    u = normalized - idx
    if degree == 3:
        idx = idx - 1
    idx = torch.clamp(idx, 0, k - order).long()
    offsets = torch.arange(order, device=knots.device)
    if idx.dim() == 0:
        return knots[:, idx + offsets], u.expand(n)
    seg_idx = idx[:, None] + offsets
    return torch.gather(knots, 1, seg_idx[..., None].expand(-1, -1, knots.shape[2])), u


def spline_eval_vec(knots: torch.Tensor, t, degree: int = 3) -> torch.Tensor:
    """The Euclidean twin of ``spline_eval`` for vector-valued knot tracks
    (N, K, C)."""
    seg, uu = _segments(knots, t, degree)
    if degree == 3:
        ct, _ = cubic_coeffs(torch.clamp(uu, _EPS, 1.0 - _EPS))
    else:
        u1 = uu[..., None]
        ct = torch.cat([1.0 - u1, u1], dim=-1)
    return torch.sum(ct[..., None] * seg, dim=-2)


def spline_eval(knots_xyz: torch.Tensor, knots_quat: torch.Tensor, t,
                degree: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every point's spline at time ``t``: knots_xyz (N, K, 3), knots_quat
    (N, K, 4) wxyz -> (xyz (N, 3), unit quaternions (N, 4))."""
    seg_xyz, uu = _segments(knots_xyz, t, degree)
    seg_quat, _ = _segments(knots_quat, t, degree)
    if degree == 3:
        return cubic_bspline_interpolation(seg_xyz, seg_quat, uu)
    return linear_interpolation(seg_xyz, seg_quat, uu)
