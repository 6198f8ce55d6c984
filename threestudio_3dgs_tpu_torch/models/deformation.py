"""HexPlane / K-planes deformation field (port of the JAX package's
``models/deformation.py``).

Six coordinate-pair 2D feature planes per scale, sampled bilinearly, their
features multiplied over the planes and concatenated over the multires
scales, a trunk MLP and four heads giving residual deltas for position,
scale, rotation and opacity.  With ``use_res`` the heads start at zero, so
the field starts as the identity.

The parameters are one flat dict (it lives in the system's
``extra_params["deformation"]``, whose Adam step trains it) with the JAX
package's tree paths as names: ``grids/<scale>/<plane>``, ``trunk/<i>/w``,
``head_pos/<i>/b``, ...  ``models/convert.py`` flattens a JAX tree into
these names."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import torch

_COO_COMBS = list(itertools.combinations(range(4), 2))  # the 6 planes
HEADS = ("head_pos", "head_scale", "head_rot", "head_opacity")


@dataclasses.dataclass
class DeformationConfig:
    net_width: int = 64
    defor_depth: int = 1
    bounds: float = 1.0
    grid_out_dim: int = 32
    grid_resolution: Tuple[int, int, int, int] = (64, 64, 64, 25)
    multires: Tuple[int, ...] = (1, 2, 4, 8)
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    use_res: bool = True  # zero-init residual heads


def init_deformation_params(cfg: DeformationConfig, generator: torch.Generator,
                            device=None) -> Dict[str, torch.Tensor]:
    """The planes (time planes at 1, the others uniform in [0.1, 0.5]) and
    the MLPs (He-normal weights, zero biases; zero heads with
    ``use_res``), drawn from ``generator``."""
    device = generator.device if device is None else device
    params: Dict[str, torch.Tensor] = {}

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=generator.device).to(device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=generator.device).to(device)

    for s, res_mult in enumerate(cfg.multires):
        reso = [r * res_mult for r in cfg.grid_resolution[:3]] + [cfg.grid_resolution[3]]
        for p, comb in enumerate(_COO_COMBS):
            h, w = reso[comb[1]], reso[comb[0]]
            if 3 in comb:
                plane = torch.ones((cfg.grid_out_dim, h, w), device=device)
            else:
                plane = 0.1 + 0.4 * rand(cfg.grid_out_dim, h, w)
            params[f"grids/{s}/{p}"] = plane

    def linear(name, din, dout, zero=False):
        params[f"{name}/w"] = (torch.zeros((din, dout), device=device) if zero
                               else randn(din, dout) * (2.0 / din) ** 0.5)
        params[f"{name}/b"] = torch.zeros(dout, device=device)

    w = cfg.net_width
    linear("trunk/0", cfg.grid_out_dim * len(cfg.multires), w)
    for i in range(1, cfg.defor_depth):
        linear(f"trunk/{i}", w, w)
    for head, dout in zip(HEADS, (3, 3, 4, 1)):
        linear(f"{head}/0", w, w, cfg.use_res)
        linear(f"{head}/1", w, dout, cfg.use_res)
    return params


def _grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of plane (C, H, W) at coords (N, 2) in [-1, 1]
    (align-corners, border clamped; the fraction clipped to [0, 1]).  The
    corners are gathered from the flattened plane by ``index_select``,
    whose backward adds with atomics: advanced indexing's backward walks
    each cell's duplicates serially on the card, and every point of one
    time shares a time plane's row (231,773 mesh vertices on dynamic
    SuGaR's planes)."""
    c, h, w = plane.shape
    x = (coords[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0i, x1i, y0i, y1i = (v.long() for v in (x0, x1, y0, y1))
    flat = plane.reshape(c, h * w)

    def corner(yi, xi):
        return torch.index_select(flat, 1, yi * w + xi)  # (C, N)

    p00, p01 = corner(y0i, x0i), corner(y0i, x1i)
    p10, p11 = corner(y1i, x0i), corner(y1i, x1i)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return (top * (1 - fy) + bot * fy).T  # (N, C)


def hexplane_features(params: Dict[str, torch.Tensor], cfg: DeformationConfig,
                      xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """xyz (N, 3) world, t (N,) in [-1, 1] -> features (N, 32 * scales)."""
    pts = torch.clamp(xyz / cfg.bounds, -1.0, 1.0)
    coords4 = torch.cat([pts, t[:, None]], dim=1)
    outs = []
    for s in range(len(cfg.multires)):
        interp = 1.0
        for p, comb in enumerate(_COO_COMBS):
            interp = interp * _grid_sample_2d(params[f"grids/{s}/{p}"], coords4[:, list(comb)])
        outs.append(interp)
    return torch.cat(outs, dim=-1)


def _layers(params: Dict[str, torch.Tensor], name: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    out = []
    while f"{name}/{len(out)}/w" in params:
        i = len(out)
        out.append((params[f"{name}/{i}/w"], params[f"{name}/{i}/b"]))
    return out


def _mlp(layers, x: torch.Tensor, relu_first: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        if relu_first or i > 0:
            x = torch.relu(x)
        x = x @ w + b
    return x


def deformation_apply(params: Dict[str, torch.Tensor], cfg: DeformationConfig,
                      xyz: torch.Tensor, scaling: torch.Tensor, rotation: torch.Tensor,
                      opacity: torch.Tensor, t: torch.Tensor):
    """Residual deltas on the raw (pre-activation) parameters at t (N,) in
    [-1, 1]: (xyz, scaling, rotation, opacity)."""
    hidden = _mlp(_layers(params, "trunk"), hexplane_features(params, cfg, xyz, t))

    def head(name):
        return _mlp(_layers(params, name), hidden, relu_first=True)

    new_xyz = xyz + head("head_pos")
    new_scaling = scaling if cfg.no_ds else scaling + head("head_scale")
    new_rotation = rotation if cfg.no_dr else rotation + head("head_rot")
    new_opacity = opacity if cfg.no_do else opacity + head("head_opacity")
    return new_xyz, new_scaling, new_rotation, new_opacity


def deformation_xyz_rotation(params, cfg: DeformationConfig, xyz, rotation,
                             t) -> Tuple[torch.Tensor, torch.Tensor]:
    """The position and rotation deltas alone."""
    hidden = _mlp(_layers(params, "trunk"), hexplane_features(params, cfg, xyz, t))
    return (_mlp(_layers(params, "head_pos"), hidden, relu_first=True),
            _mlp(_layers(params, "head_rot"), hidden, relu_first=True))

