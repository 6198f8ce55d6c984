"""Real spherical-harmonics colour evaluation (degrees 0-4) in torch.

Port of the JAX package's ``ops/sh.py``.  Coefficients are laid out
(..., K, 3) with K = (degree+1)^2."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb):
    """Mean colour -> DC coefficient."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """DC coefficient -> mean colour."""
    return sh * C0 + 0.5


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis values for unit directions (..., 3) -> (..., K)."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        basis += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        basis += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3.0 * xx - yy),
            C4[2] * xy * (7.0 * zz - 1.0),
            C4[3] * yz * (7.0 * zz - 3.0),
            C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            C4[5] * xz * (7.0 * zz - 3.0),
            C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            C4[7] * xz * (xx - 3.0 * yy),
            C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(basis, dim=-1)


def eval_sh(sh_coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH coefficients (..., K, C) + unit directions (..., 3) -> (..., C).
    Only the first (degree+1)^2 bands are used."""
    k = num_sh_bases(degree)
    basis = sh_basis(dirs, degree)
    return torch.einsum("...k,...kc->...c", basis, sh_coeffs[..., :k, :])


def eval_sh_color(sh_coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH -> RGB as the CUDA rasterizer does: +0.5 offset, clamped at 0."""
    return torch.clamp_min(eval_sh(sh_coeffs, dirs, degree) + 0.5, 0.0)
