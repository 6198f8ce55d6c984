"""Pair expansion: the CUDA kernels K4 and K6 and their plain torch twins.

Port of the JAX package's ``ops/rasterizer/expand_pallas.py``
(``expand_bin_pallas`` / ``expand_bin_pallas_packed``, replaced here by
``csrc/expand.cu``) together with the helpers binning shares with it
(``MASK_K``, ``MASK_NONE``, ``tile_reachable``).

For depth rank i with ``counts[i]`` pairs starting at ``offsets[i]``, every
pair gets its depth slot i, its Gaussian id ``depth_order[i]``, its tile id
and the int64 tile-sort key ``(tile << 32) | slot``:

  * masked Gaussians (rects of <= MASK_K tiles, reachable tiles as a
    bitmask) map pair r to the r-th set bit of the mask;
  * otherwise pair r is tile (y0 + r // w, x0 + r % w) of the rect, and
    with cull fields it becomes tile ``num_tiles`` when alpha cannot reach
    1/255 anywhere in that tile.

The rect and mask fields are one (N, 4) int32 row per Gaussian
(``pack_rect``: x0, y0, w, mask), the cull fields (N, 6) f32, both indexed
by ORIGINAL Gaussian id.  With ``view_grid_y`` > 0 (the batched render's
grid of views stacked as tile rows, the means view-local) the cull tests
the tile at its row in its view, ``ty % view_grid_y``.  ``expand_bin``
takes the plain twin for CPU tensors and launches the kernel for CUDA
tensors (a launch on stacked views is also counted under
``native.SHAPE_LAUNCHES[("expand_bin", "stacked")]``).  K6 (``expand_slots``,
port of ``expand_slots_pallas``) is the slot column alone, from int32
offsets; it routes the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import native

MASK_K = 24
MASK_NONE = 1 << 24
ALPHA_MIN = 1.0 / 255.0


def tile_reachable(x0, y0, tile_size: float, mx, my, ca, cb, cc, opa):
    """Can alpha = opa * exp(-Q/2) reach ALPHA_MIN inside the pixel rect
    [x0, x0+ts-1] x [y0, y0+ts-1]?  Q(d) = ca dx^2 + 2 cb dx dy + cc dy^2.
    Exact continuous max: the mean is inside, or the max lies on the near
    vertical or horizontal edge with its 1D argmin clamped to the segment.
    Operation order matches the kernel's and the JAX package's."""
    x1 = x0 + (tile_size - 1.0)
    y1 = y0 + (tile_size - 1.0)
    dxe = torch.minimum(torch.maximum(mx, x0), x1) - mx
    dye = torch.minimum(torch.maximum(my, y0), y1) - my
    sa = torch.clamp_min(ca, 1e-12)
    sc = torch.clamp_min(cc, 1e-12)
    dy1 = torch.minimum(torch.maximum(-cb * dxe / sc, y0 - my), y1 - my)
    q1 = ca * dxe * dxe + 2.0 * cb * dxe * dy1 + cc * dy1 * dy1
    dx2 = torch.minimum(torch.maximum(-cb * dye / sa, x0 - mx), x1 - mx)
    q2 = ca * dx2 * dx2 + 2.0 * cb * dx2 * dye + cc * dye * dye
    qmin = torch.minimum(q1, q2)
    return opa * torch.exp(-0.5 * qmin) >= ALPHA_MIN


def select_nth_set_bit(m: torch.Tensor, r: torch.Tensor):
    """Position of the (r+1)-th set bit of each mask.  Returns (j, found)."""
    cum = torch.zeros_like(m)
    jsel = torch.zeros_like(m)
    target = r.to(m.dtype) + 1
    for j in range(MASK_K):
        bit = (m >> j) & 1
        cum = cum + bit
        jsel = torch.where((bit == 1) & (cum == target), torch.full_like(m, j), jsel)
    return jsel, cum >= target


def pack_rect(x0, y0, rect_w, mask) -> torch.Tensor:
    """The per-Gaussian fields K4 reads, one 16-byte row per Gaussian:
    (N, 4) int32 [x0, y0, w, mask]."""
    return torch.stack([x0, y0, rect_w, mask], dim=1).to(torch.int32)


def expand_bin_torch(
    offsets, counts, depth_order, rect, n_pairs: int, grid_x: int,
    tile_size: int = 0, num_tiles: int = 0, cull_fields: Optional[torch.Tensor] = None,
    view_grid_y: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K4 (the repeat_interleave form).  Returns
    (slot, gauss, tile) int32 and key int64, each (n_pairs,)."""
    device = offsets.device
    n = counts.shape[0]
    slot = torch.repeat_interleave(torch.arange(n, device=device), counts)[:n_pairs]
    g = depth_order[slot]
    r = torch.arange(slot.shape[0], device=device) - offsets[slot]
    fields = rect[g].long()
    x0, y0, m = fields[:, 0], fields[:, 1], fields[:, 3]
    w = torch.clamp_min(fields[:, 2], 1)
    tx = x0 + r % w
    ty = y0 + r // w
    tile = ty * grid_x + tx
    if cull_fields is not None:
        cf = cull_fields[g]
        ty_view = ty % view_grid_y if view_grid_y else ty
        keep = tile_reachable(
            (tx * tile_size).float(), (ty_view * tile_size).float(), float(tile_size),
            cf[:, 0], cf[:, 1], cf[:, 2], cf[:, 3], cf[:, 4], cf[:, 5],
        )
        tile = torch.where(keep, tile, torch.full_like(tile, num_tiles))
    jsel, found = select_nth_set_bit(m, r)
    tile_m = (y0 + jsel // w) * grid_x + x0 + jsel % w
    tile_m = torch.where(found, tile_m, torch.full_like(tile_m, num_tiles))
    tile = torch.where(m != MASK_NONE, tile_m, tile)
    key = (tile << 32) | slot
    return slot.int(), g.int(), tile.int(), key


def expand_bin_cuda(
    offsets, counts, depth_order, rect, n_pairs: int, grid_x: int,
    tile_size: int = 0, num_tiles: int = 0, cull_fields: Optional[torch.Tensor] = None,
    view_grid_y: int = 0,
):
    """K4 on the card: the grid spans the pairs, each block searching the
    offsets for its slots.  It reads no counts: under ``expand_bin``'s
    contract pair p < n_pairs belongs to the last slot whose offset is
    <= p, which ``counts`` (checked here) only restates."""
    n = counts.shape[0]
    if view_grid_y < 0:
        raise ValueError(f"view_grid_y must be >= 0, got {view_grid_y}")
    for t, name in ((offsets, "offsets"), (counts, "counts"), (depth_order, "depth_order")):
        native.check_cuda_tensor(t, name, torch.int64, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must have {n} entries")
    native.check_cuda_tensor(rect, "rect", torch.int32, 2)
    if tuple(rect.shape) != (n, 4) or rect.data_ptr() % 16:
        raise ValueError(f"rect must be ({n}, 4) and 16-byte aligned")
    if cull_fields is not None:
        native.check_cuda_tensor(cull_fields, "cull_fields", torch.float32, 2)
        if tuple(cull_fields.shape) != (n, 6) or cull_fields.data_ptr() % 8:
            raise ValueError(f"cull_fields must be ({n}, 6) and 8-byte aligned")
    device = offsets.device
    slot = torch.empty(n_pairs, dtype=torch.int32, device=device)
    gauss = torch.empty_like(slot)
    tile = torch.empty_like(slot)
    key = torch.empty(n_pairs, dtype=torch.int64, device=device)
    native.launch(
        "expand_bin", offsets.data_ptr(), depth_order.data_ptr(), rect.data_ptr(),
        None if cull_fields is None else cull_fields.data_ptr(),
        slot.data_ptr(), gauss.data_ptr(), tile.data_ptr(), key.data_ptr(),
        n, n_pairs, grid_x, view_grid_y, tile_size, num_tiles, native.stream_handle(device),
        shape="stacked" if view_grid_y else "",
    )
    return slot, gauss, tile, key


def expand_bin(
    offsets, counts, depth_order, rect, n_pairs: int, grid_x: int,
    tile_size: int = 0, num_tiles: int = 0, cull_fields: Optional[torch.Tensor] = None,
    view_grid_y: int = 0,
):
    """``offsets`` is the exclusive prefix of the full pair counts and
    ``counts`` those counts clipped so that the pairs fill exactly
    [0, n_pairs): offsets[i] + counts[i] <= n_pairs."""
    fn = expand_bin_torch if offsets.device.type == "cpu" else expand_bin_cuda
    return fn(
        offsets, counts, depth_order, rect, n_pairs, grid_x,
        tile_size=tile_size, num_tiles=num_tiles, cull_fields=cull_fields,
        view_grid_y=view_grid_y,
    )


# ---------------------------------------------------------------------------
# K6: slot-only monotone expand (expand_slots_pallas).  No path of the JAX
# package runs it; it stands alone here too.
# ---------------------------------------------------------------------------


def expand_slots_torch(offsets: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """Plain twin of K6: scatter-max of arange(N) at the offsets (offsets
    >= max_pairs dropped), then a running max.  (max_pairs,) int32."""
    n = offsets.shape[0]
    marks = torch.zeros(max_pairs + 1, dtype=torch.long, device=offsets.device)
    marks.scatter_reduce_(0, offsets.long().clamp(max=max_pairs),
                          torch.arange(n, device=offsets.device), reduce="amax")
    return torch.cummax(marks[:max_pairs], dim=0).values.int()


def expand_slots_cuda(offsets: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """K6 on the card: each block finds the slots of its 2048 positions
    in the offsets ((N,) int32, monotone), stages them and resolves every
    position p to the last i with offsets[i] <= p."""
    native.check_cuda_tensor(offsets, "offsets", torch.int32, 1)
    slot = torch.empty(max_pairs, dtype=torch.int32, device=offsets.device)
    native.launch("expand_slots", offsets.data_ptr(), slot.data_ptr(), offsets.shape[0],
                  max_pairs, native.stream_handle(offsets.device))
    return slot


def expand_slots(offsets: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """For each pair position p < max_pairs, the last Gaussian i (in depth
    order) with offsets[i] <= p; meaningful for p < the pair total."""
    fn = expand_slots_torch if offsets.device.type == "cpu" else expand_slots_cuda
    return fn(offsets, max_pairs)
