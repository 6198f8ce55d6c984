"""Tile blend: the CUDA kernels K1 (forward) and K2 (backward), their plain
torch twins, and ``tiles_to_image``.

Port of the JAX package's ``ops/rasterizer/blend_jax.py`` (the plain twin)
and ``blend_pallas.py`` (the TPU kernels, replaced here by
``csrc/blend.cu``).  Per tile of ``tile_size``^2 pixels, pairs in depth
order; per-pair feature rows are
``[x, y, conic_a, conic_b, conic_c, opacity, channel_0 .. channel_{C-1}]``
and the output is (num_tiles, npix, C+1) with channel C the weight sum
(the alpha map).

The plain twin follows blend_jax's chunked rule, vectorised over all tiles
at once: carry the raw transmittance R, include a pair iff its inclusive
product stays >= 1e-4, and in the backward take the suffix sums as
U_tot - prefix in forward order.  The kernels walk the same pairs one at a
time (see the source note in ``csrc/blend.cu``).  ``blend_forward`` and
``blend_backward`` take the plain twin for CPU tensors and launch the
kernel for CUDA tensors; each launch is also counted under its channel
count (``native.SHAPE_LAUNCHES[(fn, "C<n>")]``) and, on a grid of stacked
views, under ``(fn, "stacked")``.

``view_grid_y`` (0 = one view): the single-pass batched render stacks B
views as tile rows of one (B * view_grid_y, grid_x) grid, the pairs'
means view-local; a tile's pixel row is then taken in its view,
``(tile // grid_x) % view_grid_y``, so every pair's arithmetic is that of
the view's own render.
"""

from __future__ import annotations

import torch

from .. import native

CHUNK = 64  # pairs per step of the plain twin
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
KERNEL_CHANNELS = range(3, 9)  # the channel counts the kernels are built for
KERNEL_TILE_SIZES = (16, 32)
# the kernels' work units, square blocks of pixels (csrc/blend.cu kFwdUnit,
# kBwdUnit)
FWD_UNIT = 8
BWD_UNIT = 16


def _tile_pixel_coords(num_tiles: int, grid_x: int, tile_size: int, device,
                       view_grid_y: int = 0):
    """Pixel-centre coordinates (num_tiles, npix) of every tile, x-major,
    view-local when ``view_grid_y`` > 0."""
    npix = tile_size * tile_size
    tile = torch.arange(num_tiles, device=device)
    lane = torch.arange(npix, device=device)
    row = tile // grid_x
    if view_grid_y:
        row = row % view_grid_y
    px = (tile % grid_x)[:, None] * tile_size + lane % tile_size
    py = row[:, None] * tile_size + lane // tile_size
    return px.float(), py.float()


def _chunk_alpha(f, px, py, pmask):
    """alpha (T, CHUNK, npix) with all skip rules applied, plus exp(power),
    the offsets and the clamp-gradient mask the backward needs."""
    x, y, ca, cb, cc, opa = (f[..., j : j + 1] for j in range(6))
    dx = px[:, None, :] - x
    dy = py[:, None, :] - y
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    gauss = torch.exp(torch.clamp_max(power, 0.0))
    alpha = opa * gauss
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & pmask[..., None]
    alpha_c = torch.where(ok, torch.clamp_max(alpha, ALPHA_MAX), torch.zeros_like(alpha))
    # where alpha hit ALPHA_MAX the derivative wrt opacity/power is zero
    unclamped = ok & (alpha < ALPHA_MAX)
    return alpha_c, gauss, dx, dy, unclamped


class _ChunkWalk:
    """Shared chunk iteration of the plain twins: per step, the (T, CHUNK)
    pair indices of every still-active tile."""

    def __init__(self, pair_feats, tile_ranges, num_tiles, npix):
        device = pair_feats.device
        self.p_total, self.f_dim = pair_feats.shape
        self.feats = torch.cat(
            [pair_feats, torch.zeros((CHUNK, self.f_dim), device=device)], dim=0
        )
        self.ends = tile_ranges[1:].long()
        self.base = tile_ranges[:-1].long().clone()
        self.raw = torch.ones((num_tiles, npix), device=device)
        self.iota = torch.arange(CHUNK, device=device)
        self.active = self.base < self.ends

    def step(self):
        idx = self.base[:, None] + self.iota
        pmask = (idx < self.ends[:, None]) & self.active[:, None]
        idx = torch.clamp_max(idx, self.p_total + CHUNK - 1)
        return idx, pmask, self.feats[idx]

    def advance(self, cum_incl_last):
        self.raw = torch.where(self.active[:, None], cum_incl_last, self.raw)
        self.base = self.base + CHUNK
        self.active = (
            self.active & (self.base < self.ends) & (self.raw.amax(dim=1) >= T_EPS)
        )


def _weights(alpha, raw):
    om = 1.0 - alpha
    cum_incl = raw[:, None, :] * torch.cumprod(om, dim=1)
    include = cum_incl >= T_EPS
    cum_excl = torch.cat([raw[:, None, :], cum_incl[:, :-1]], dim=1)
    w = torch.where(include, alpha * cum_excl, torch.zeros_like(alpha))
    return om, cum_incl, include, cum_excl, w


def _colors_ext(f, n_channels):
    ones = torch.ones(f.shape[:-1] + (1,), device=f.device)
    return torch.cat([f[..., 6 : 6 + n_channels], ones], dim=-1)


def blend_forward_torch(pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels,
                        view_grid_y=0):
    """Plain twin of K1.  Returns (num_tiles, npix, C+1)."""
    num_tiles = grid_x * grid_y
    npix = tile_size * tile_size
    px, py = _tile_pixel_coords(num_tiles, grid_x, tile_size, pair_feats.device, view_grid_y)
    out = torch.zeros((num_tiles, npix, n_channels + 1), device=pair_feats.device)
    walk = _ChunkWalk(pair_feats, tile_ranges, num_tiles, npix)
    while bool(walk.active.any()):
        _, pmask, f = walk.step()
        alpha, _, _, _, _ = _chunk_alpha(f, px, py, pmask)
        _, cum_incl, _, _, w = _weights(alpha, walk.raw)
        out = out + torch.einsum("tkc,tkp->tpc", _colors_ext(f, n_channels), w)
        walk.advance(cum_incl[:, -1])
    return out


def blend_backward_torch(
    pair_feats, tile_ranges, out, g_out, grid_x, grid_y, tile_size, n_channels, view_grid_y=0
):
    """Plain twin of K2.  Returns d pair_feats (P, 6+C)."""
    num_tiles = grid_x * grid_y
    npix = tile_size * tile_size
    device = pair_feats.device
    px, py = _tile_pixel_coords(num_tiles, grid_x, tile_size, device, view_grid_y)
    walk = _ChunkWalk(pair_feats, tile_ranges, num_tiles, npix)
    grads = torch.zeros((walk.p_total + CHUNK, walk.f_dim), device=device)
    u_tot = torch.sum(g_out * out, dim=-1)  # (T, npix)
    prefix = torch.zeros((num_tiles, npix), device=device)
    while bool(walk.active.any()):
        idx, pmask, f = walk.step()
        alpha, gauss, dx, dy, unclamped = _chunk_alpha(f, px, py, pmask)
        om, cum_incl, include, cum_excl, w = _weights(alpha, walk.raw)
        u = torch.einsum("tkc,tpc->tkp", _colors_ext(f, n_channels), g_out)
        prefix_inc = prefix[:, None, :] + torch.cumsum(u * w, dim=1)
        suffix = u_tot[:, None, :] - prefix_inc
        zero = torch.zeros_like(alpha)
        d_alpha = torch.where(
            include, u * cum_excl - suffix / torch.clamp_min(om, 1e-6), zero
        )
        d_g = torch.where(unclamped, d_alpha, zero)
        ca, cb, cc, opa = (f[..., j : j + 1] for j in (2, 3, 4, 5))
        d_power = opa * gauss * d_g
        d_feats = torch.cat(
            [
                torch.stack(
                    [
                        torch.sum(d_power * (ca * dx + cb * dy), dim=-1),
                        torch.sum(d_power * (cc * dy + cb * dx), dim=-1),
                        torch.sum(d_power * (-0.5 * dx * dx), dim=-1),
                        torch.sum(d_power * (-dx * dy), dim=-1),
                        torch.sum(d_power * (-0.5 * dy * dy), dim=-1),
                        torch.sum(gauss * d_g, dim=-1),
                    ],
                    dim=-1,
                ),
                torch.einsum("tkp,tpc->tkc", w, g_out[..., :n_channels]),
            ],
            dim=-1,
        )
        grads[idx[pmask]] = d_feats[pmask]
        prefix = torch.where(walk.active[:, None], prefix_inc[:, -1], prefix)
        walk.advance(cum_incl[:, -1])
    return grads[: walk.p_total]


def _check_view_grid_y(grid_y, view_grid_y):
    if view_grid_y < 0 or (view_grid_y and grid_y % view_grid_y):
        raise ValueError(f"view_grid_y {view_grid_y} must be 0 or divide grid_y {grid_y}")


def _check_blend_args(pair_feats, tile_ranges, num_tiles, tile_size, n_channels):
    if n_channels not in KERNEL_CHANNELS:
        raise ValueError(f"blend kernels take 3 to 8 channels, got {n_channels}")
    if tile_size not in KERNEL_TILE_SIZES:
        raise ValueError(f"blend kernels take tile size {KERNEL_TILE_SIZES}, got {tile_size}")
    native.check_cuda_tensor(pair_feats, "pair_feats", torch.float32, 2)
    native.check_cuda_tensor(tile_ranges, "tile_ranges", torch.int64, 1)
    if tile_ranges.shape[0] != num_tiles + 1:
        raise ValueError(f"tile_ranges must have {num_tiles + 1} entries, got {tile_ranges.shape[0]}")
    if pair_feats.shape[1] != 6 + n_channels:
        raise ValueError(f"pair_feats has {pair_feats.shape[1]} columns, want {6 + n_channels}")


def backward_scratch(num_tiles: int, n_pairs: int, tile_size: int, n_feats: int, device):
    """K2's scratch: the heaviest-first tile order (T,) i32 and, when a
    tile has more than one unit, each unit's partial gradient rows (U, P, F)
    f32 that the tile's last unit sums, each unit's stop (T, U) i64 and the
    tiles' arrival counters (T,) i32 (empty otherwise)."""
    units = (tile_size // BWD_UNIT) ** 2
    split = units > 1

    def empty(shape, dtype):
        return torch.empty(shape if split else (0,), dtype=dtype, device=device)

    return dict(
        partial=empty((units, n_pairs, n_feats), torch.float32),
        stops=empty((num_tiles, units), torch.int64),
        arrive=empty((num_tiles,), torch.int32),
        order=torch.empty(num_tiles, dtype=torch.int32, device=device),
    )


def _shape_tags(n_channels, view_grid_y):
    return (f"C{n_channels}",) + (("stacked",) if view_grid_y else ())


def blend_forward_cuda(pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels,
                       view_grid_y=0):
    """K1 on the card: FWD_UNIT x FWD_UNIT-pixel units, heaviest tile
    first, one thread per pixel."""
    num_tiles = grid_x * grid_y
    _check_blend_args(pair_feats, tile_ranges, num_tiles, tile_size, n_channels)
    _check_view_grid_y(grid_y, view_grid_y)
    device = pair_feats.device
    out = torch.empty(
        (num_tiles, tile_size * tile_size, n_channels + 1), dtype=torch.float32, device=device
    )
    order = torch.empty(num_tiles, dtype=torch.int32, device=device)
    native.launch(
        "blend_forward", pair_feats.data_ptr(), tile_ranges.data_ptr(), out.data_ptr(),
        order.data_ptr(), num_tiles, grid_x, view_grid_y, tile_size, n_channels,
        native.stream_handle(device), shape=_shape_tags(n_channels, view_grid_y),
    )
    return out


def blend_backward_cuda(
    pair_feats, tile_ranges, out, g_out, grid_x, grid_y, tile_size, n_channels, view_grid_y=0
):
    """K2 on the card: replays the forward walk per pixel and writes each
    pair's gradient row once (rows no pixel reached stay zero); a tile's
    units are summed in unit order through the scratch."""
    num_tiles = grid_x * grid_y
    _check_blend_args(pair_feats, tile_ranges, num_tiles, tile_size, n_channels)
    _check_view_grid_y(grid_y, view_grid_y)
    native.check_cuda_tensor(out, "out", torch.float32, 3)
    native.check_cuda_tensor(g_out, "g_out", torch.float32, 3)
    shape = (num_tiles, tile_size * tile_size, n_channels + 1)
    if tuple(out.shape) != shape or tuple(g_out.shape) != shape:
        raise ValueError(f"out/g_out must be {shape}")
    device = pair_feats.device
    n_pairs, n_feats = pair_feats.shape
    d_feats = torch.zeros_like(pair_feats)
    scratch = backward_scratch(num_tiles, n_pairs, tile_size, n_feats, device)
    native.launch(
        "blend_backward", pair_feats.data_ptr(), tile_ranges.data_ptr(), out.data_ptr(),
        g_out.data_ptr(), d_feats.data_ptr(),
        *(scratch[k].data_ptr() for k in ("partial", "stops", "arrive", "order")),
        n_pairs, num_tiles, grid_x, view_grid_y, tile_size, n_channels,
        native.stream_handle(device), shape=_shape_tags(n_channels, view_grid_y),
    )
    return d_feats


def blend_forward(pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels,
                  view_grid_y=0):
    fn = blend_forward_torch if pair_feats.device.type == "cpu" else blend_forward_cuda
    return fn(pair_feats, tile_ranges, grid_x, grid_y, tile_size, n_channels, view_grid_y)


def blend_backward(pair_feats, tile_ranges, out, g_out, grid_x, grid_y, tile_size, n_channels,
                   view_grid_y=0):
    fn = blend_backward_torch if pair_feats.device.type == "cpu" else blend_backward_cuda
    return fn(pair_feats, tile_ranges, out, g_out, grid_x, grid_y, tile_size, n_channels,
              view_grid_y)


def tiles_to_image(tiled, grid_x: int, grid_y: int, tile_size: int, height: int, width: int):
    """(T, npix, C) -> (H, W, C), cropping tile padding.  A grid of B
    stacked views gives the tall (B * view_h, W, C) image."""
    c = tiled.shape[2]
    img = tiled.reshape(grid_y, grid_x, tile_size, tile_size, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * tile_size, grid_x * tile_size, c)
    return img[:height, :width]
