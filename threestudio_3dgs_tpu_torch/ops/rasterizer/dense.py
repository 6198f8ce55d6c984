"""Dense differentiable renderer, for tests (port of the JAX package's
``ops/rasterizer/dense.py``): the blend over all depth-sorted Gaussians x
all pixels with no binning, through a plain ``torch.cumprod``, so torch's
autograd differentiates straight through it.  Its gradients check the
hand-written backward of the tiled blend (``api.Blend``: K2 and its plain
twin).

The same rules as the tiled blend: tile-rect membership (not a per-pixel
radius), the alpha skip rules and the inclusive-transmittance stop."""

from __future__ import annotations

import torch

from .blend import ALPHA_MAX, ALPHA_MIN, T_EPS


def dense_render(
    means2d: torch.Tensor,  # (N, 2)
    depths: torch.Tensor,  # (N,)
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C)
    opacities: torch.Tensor,  # (N,)
    visible: torch.Tensor,  # (N,) bool
    tiles_min: torch.Tensor,  # (N, 2) int
    tiles_max: torch.Tensor,  # (N, 2) int
    height: int,
    width: int,
    tile_size: int,
):
    """Returns (image (H, W, C), alpha (H, W))."""
    inf = torch.full_like(depths, float("inf"))
    order = torch.sort(torch.where(visible, depths.detach(), inf), stable=True).indices
    means2d, conics, colors = means2d[order], conics[order], colors[order]
    opacities, visible = opacities[order], visible[order]
    tiles_min, tiles_max = tiles_min[order], tiles_max[order]

    py, px = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=means2d.device),
                            torch.arange(width, dtype=torch.float32, device=means2d.device),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    tile_x = (px // tile_size).long()
    tile_y = (py // tile_size).long()

    dx = px[None, :] - means2d[:, 0:1]
    dy = py[None, :] - means2d[:, 1:2]
    ca, cb, cc = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = opacities[:, None] * torch.exp(torch.clamp_max(power, 0.0))
    in_rect = ((tile_x[None, :] >= tiles_min[:, 0:1]) & (tile_x[None, :] < tiles_max[:, 0:1])
               & (tile_y[None, :] >= tiles_min[:, 1:2]) & (tile_y[None, :] < tiles_max[:, 1:2]))
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect & visible[:, None]
    alpha = torch.where(ok, torch.clamp_max(alpha, ALPHA_MAX), torch.zeros_like(alpha))

    cum_incl = torch.cumprod(1.0 - alpha, dim=0)
    cum_excl = torch.cat([torch.ones_like(alpha[:1]), cum_incl[:-1]], dim=0)
    w = torch.where(cum_incl >= T_EPS, alpha * cum_excl, torch.zeros_like(alpha))  # (N, HW)
    img = torch.einsum("np,nc->pc", w, colors)
    return img.reshape(height, width, -1), w.sum(dim=0).reshape(height, width)
