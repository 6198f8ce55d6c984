"""Per-Gaussian covariance math in torch (port of the JAX package's
``ops/gaussian_math.py``)."""

from __future__ import annotations

import torch

from . import quaternion


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s): (..., 3) x (..., 4) -> (..., 3, 3)."""
    return quaternion.to_rotation_matrix(quats) * scales[..., None, :]


def covariance_from_scaling_rotation(
    scales: torch.Tensor, quats: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Full 3D covariance Sigma = L L^T, (..., 3, 3)."""
    length = build_scaling_rotation(scaling_modifier * scales, quats)
    return length @ length.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) upper triangle [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unstrip_symmetric(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) upper triangle -> (..., 3, 3) symmetric."""
    a, b, c, d, e, f = cov6.unbind(-1)
    return torch.stack(
        [torch.stack([a, b, c], dim=-1), torch.stack([b, d, e], dim=-1),
         torch.stack([c, e, f], dim=-1)],
        dim=-2,
    )


def gaussian_3d_coeff(xyzs: torch.Tensor, covs6: torch.Tensor) -> torch.Tensor:
    """Unnormalised Gaussian density exp(-0.5 d^T Sigma^-1 d) at offsets
    ``xyzs`` (..., 3) for stripped covariances ``covs6`` (..., 6); a
    positive exponent (a covariance that is not positive definite) gives
    exp(-1e10) = 0."""
    x, y, z = xyzs.unbind(-1)
    a, b, c, d, e, f = covs6.unbind(-1)
    det = a * d * f + 2 * e * c * b - e * e * a - c * c * d - b * b * f
    inv_det = 1.0 / (det + 1e-24)
    inv_a = (d * f - e * e) * inv_det
    inv_b = (e * c - b * f) * inv_det
    inv_c = (e * b - c * d) * inv_det
    inv_d = (a * f - c * c) * inv_det
    inv_e = (b * c - e * a) * inv_det
    inv_f = (a * d - b * b) * inv_det
    power = (-0.5 * (x * x * inv_a + y * y * inv_d + z * z * inv_f)
             - x * y * inv_b - x * z * inv_c - y * z * inv_e)
    power = torch.where(power > 0.0, torch.full_like(power, -1e10), power)
    return torch.exp(power)
