"""Small image-space ops of the renderer variants (port of the JAX
package's ``ops/image.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_to_normal(xyz_map: torch.Tensor) -> torch.Tensor:
    """Screen-space normals from an xyz map (H, W, 3) by central
    differences with zero padding: ddx = xyz[:, x+1] - xyz[:, x-1], ddy
    the same along y, normal = -cross(ddx, ddy)."""
    padded = F.pad(xyz_map, (0, 0, 1, 1, 1, 1))
    ddx = padded[1:-1, 2:] - padded[1:-1, :-2]
    ddy = padded[2:, 1:-1] - padded[:-2, 1:-1]
    return -torch.linalg.cross(ddx, ddy, dim=-1)


def normalize_vec(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalise over the last axis; zero vectors map to zero with finite
    gradients.  ``v / max(norm(v), eps)`` is not safe: the derivative of the
    norm at 0 is NaN and 0 * NaN poisons the whole backward pass (the
    background pixels of the depth-normal map are exactly zero).  So the
    rsqrt sees 1 where |v|^2 < eps^2 (the inner where) and the output is 0
    there (the outer)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    is_zero = sq < eps * eps
    safe_sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(v), v * torch.rsqrt(safe_sq))
