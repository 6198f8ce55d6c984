"""The port's kernel modules (threestudio_3dgs_tpu_torch.ops.rasterizer:
expand (K4 and K6), blend, segsum) against the JAX package on the CPU.

Each test feeds the same numpy inputs to the JAX function (the Pallas kernel
in interpret mode, or the JAX twin it is held against) and to the port's
plain torch version, which is what the port's wrappers run for CPU tensors.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py and chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_expand_pallas import random_case
from test_rasterizer import make_scene
from test_torch_gpu import (
    BLEND_CASES, EXPAND_CASES as K4_EDGE_CASES, SEGSUM_CASES, blend_case, expand_case,
    segsum_case,
)
from test_torch_gpu import make_scene as port_scene

from threestudio_3dgs_tpu.ops.rasterizer import blend_jax
from threestudio_3dgs_tpu.ops.rasterizer.binning import bin_gaussians as jax_bin
from threestudio_3dgs_tpu.ops.rasterizer.expand_pallas import (
    MASK_K,
    MASK_NONE,
    _tile_reachable,
    expand_bin_pallas,
    expand_slots_pallas,
)
from threestudio_3dgs_tpu.ops.rasterizer.preprocess import project_gaussians
from threestudio_3dgs_tpu.ops.rasterizer.segsum_pallas import segsum_monotone_pallas

from threestudio_3dgs_tpu_torch.ops.rasterizer import binning, blend, expand, segsum
from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import (
    project_gaussians as port_project,
)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# K4: pair expansion
# ---------------------------------------------------------------------------


def _port_expand(offsets, depth_order, tiles_min, rect_w, grid_x, total, mask=None, **kw):
    """The port's plain expand on the JAX test's arguments: the port takes
    the rect fields packed in ORIGINAL order and the per-rank pair counts."""
    offs = np.asarray(offsets).astype(np.int64)
    counts = np.diff(np.concatenate([offs, [total]]))
    x0 = T(tiles_min[:, 0], torch.int32)
    if mask is None:
        mask = torch.full_like(x0, MASK_NONE)
    rect = expand.pack_rect(x0, T(tiles_min[:, 1], torch.int32), T(rect_w, torch.int32), mask)
    return expand.expand_bin_torch(
        T(offs), T(counts), T(depth_order, torch.int64), rect, total, grid_x, **kw,
    )


def _jax_cull_fields(n, seed):
    """test_expand_bin_feature_emission's cull fields (depth order)."""
    rng = np.random.default_rng(seed + 100)
    return np.column_stack([
        rng.normal(size=n) * 50 + 100,
        rng.normal(size=n) * 50 + 100,
        rng.uniform(0.5, 2.0, n),
        rng.uniform(-0.1, 0.1, n),
        rng.uniform(0.5, 2.0, n),
        np.full(n, 0.99),
    ]).astype(np.float32)


def _identity_masks(offsets, total):
    """test_expand_bin_mask_selection's masks (depth order): the first
    count bits set for counts <= 24, MASK_NONE otherwise."""
    counts = np.diff(np.concatenate([np.asarray(offsets), [total]])).astype(int)
    return np.array(
        [(1 << c) - 1 if 0 < c <= 24 else MASK_NONE for c in counts], np.int64
    ).astype(np.int32)


# (case, seed): the argument sets of tests/test_expand_pallas.py, plus one
# with opacities low enough that the big-rect cull really drops pairs
EXPAND_CASES = [
    ("plain", 0), ("plain", 1), ("plain", 2),
    ("cull", 0), ("cull", 3),
    ("mask", 0), ("mask", 5),
    ("cull_active", 11),
]


@pytest.mark.parametrize("case,seed", EXPAND_CASES)
def test_expand_bin_matches_pallas(case, seed):
    """(slot, gauss, tile) of every pair equal, exactly: integer outputs, and
    the reachability test runs the same float operations in the same order."""
    n = 500 if case == "plain" else 300
    offsets, depth_order, tiles_min, rect_w, grid_x, max_pairs, total = random_case(
        seed, n=n
    )
    tiles_min, rect_w, d_order = np.asarray(tiles_min), np.asarray(rect_w), np.asarray(depth_order)
    jax_kw, port_kw = {}, {}
    if case != "plain":
        cull_d = _jax_cull_fields(n, seed)
        if case == "mask":  # test_expand_bin_mask_selection's inert cull
            cull_d = np.column_stack(
                [np.full(n, 100.0), np.full(n, 100.0), np.full(n, 1.0),
                 np.zeros(n), np.full(n, 1.0), np.full(n, 0.99)]
            ).astype(np.float32)
        if case == "cull_active":
            rng = np.random.default_rng(seed)
            cull_d[:, 0] = rng.uniform(0, 16 * 16, n)
            cull_d[:, 1] = rng.uniform(0, 16 * 16, n)
            cull_d[:, 2] = rng.uniform(0.001, 0.05, n)
            cull_d[:, 4] = rng.uniform(0.001, 0.05, n)
            cull_d[:, 5] = rng.uniform(0.01, 0.99, n)
        cull_o = np.empty_like(cull_d)
        cull_o[d_order] = cull_d
        jax_kw = dict(tile_size=16, num_tiles=grid_x * 16, cull_fields_d=jnp.asarray(cull_d))
        port_kw = dict(tile_size=16, num_tiles=grid_x * 16, cull_fields=T(cull_o))
        if case == "mask":
            mask_d = _identity_masks(offsets, total)
            mask_o = np.empty_like(mask_d)
            mask_o[d_order] = mask_d
            jax_kw["mask_d"] = jnp.asarray(mask_d)
            port_kw["mask"] = T(mask_o)
    want = expand_bin_pallas(
        offsets, depth_order, tiles_min[d_order, 0], tiles_min[d_order, 1],
        rect_w[d_order], grid_x, max_pairs, interpret=True, **jax_kw,
    )
    got = _port_expand(offsets, d_order, tiles_min, rect_w, grid_x, total, **port_kw)
    if case == "cull_active":
        culled = int((got[2] == grid_x * 16).sum())
        assert 0 < culled < total, culled
    for name, w, g in zip(("slot", "gauss", "tile"), want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:total], err_msg=name)
    # the port's sort key: (tile << 32) | depth slot
    key = (got[2].long() << 32) | got[0].long()
    np.testing.assert_array_equal(got[3].numpy(), key.numpy())


@pytest.mark.parametrize("tile_size", [16, 32])
def test_plan_pairs_packs_rect_rows(tile_size):
    """plan_pairs' (N, 4) int32 rows against the four columns they replace:
    x0, y0 and the width from the projection, and the reachable-tile mask
    rebuilt tile by tile with the JAX package's _tile_reachable (MASK_NONE
    for invisible Gaussians and rects of more than MASK_K tiles)."""
    scene = port_scene("cpu", n=800, size=96, seed=4)
    proj = port_project(scene["means"], scene["scales"], scene["quats"], scene["cam"], tile_size)
    g = (96 + tile_size - 1) // tile_size
    plan = binning.plan_pairs(proj, g, g, 2**21, tile_size, scene["opac"])
    rect = plan.rect
    assert rect.dtype == torch.int32 and rect.shape == (800, 4) and rect.is_contiguous()
    tmin, tmax = proj.tiles_min.long().numpy(), proj.tiles_max.long().numpy()
    w, h = tmax[:, 0] - tmin[:, 0], tmax[:, 1] - tmin[:, 1]
    np.testing.assert_array_equal(rect[:, :3].numpy(), np.column_stack([tmin, w]))
    count = np.where(proj.visible.numpy(), w * h, 0)
    w1 = np.maximum(w, 1)
    mx, my = (jnp.asarray(proj.means2d[:, k].numpy()) for k in (0, 1))
    ca, cb, cc = (jnp.asarray(proj.conics[:, k].numpy()) for k in (0, 1, 2))
    mask = np.zeros(800, np.int64)
    for j in range(MASK_K):
        tx, ty = tmin[:, 0] + j % w1, tmin[:, 1] + j // w1
        reach = np.asarray(_tile_reachable(
            jnp.asarray((tx * tile_size).astype(np.float32)),
            jnp.asarray((ty * tile_size).astype(np.float32)), float(tile_size),
            mx, my, ca, cb, cc, jnp.asarray(scene["opac"].numpy())))
        mask |= (reach & (j < count)).astype(np.int64) << j
    small = proj.visible.numpy() & (count <= MASK_K)
    np.testing.assert_array_equal(rect[:, 3].numpy(), np.where(small, mask, MASK_NONE))
    assert small.any() and (mask[small] > 0).any()


def _expand_spec(offsets, kept, depth_order, rect, grid_x, tile_size, num_tiles, cull):
    """expand_bin's contract written out slot by slot, independent of the
    plain twin: depth slot i owns pairs [offsets[i], offsets[i] + kept[i]);
    with a mask its r-th pair is the r-th set bit's tile (num_tiles past
    the last bit), else tile r of the rect in row-major order, culled to
    num_tiles by the JAX package's _tile_reachable.  Returns (slot, gauss,
    tile) in pair order."""
    slot, gauss, tile, culled = [], [], [], []
    for i in np.flatnonzero(kept):
        assert offsets[i] == len(slot)  # the pairs fill [0, n_pairs) in slot order
        k, g = int(kept[i]), int(depth_order[i])
        x0, y0, w, m = (int(v) for v in rect[g])
        w = max(w, 1)
        if m != MASK_NONE:
            bits = [j for j in range(MASK_K) if m >> j & 1]
            tiles = [(y0 + j // w) * grid_x + x0 + j % w for j in bits[:k]]
            tiles += [num_tiles] * (k - len(tiles))
        else:
            tiles = [(y0 + r // w) * grid_x + x0 + r % w for r in range(k)]
            if cull is not None:
                culled += [(len(slot) + r, x0 + r % w, y0 + r // w, g) for r in range(k)]
        slot += [i] * k
        gauss += [g] * k
        tile += tiles
    tile = np.asarray(tile, np.int64)
    if culled:
        pos, tx, ty, g = (np.asarray(c) for c in zip(*culled))
        reach = np.asarray(_tile_reachable(
            jnp.asarray((tx * tile_size).astype(np.float32)),
            jnp.asarray((ty * tile_size).astype(np.float32)), float(tile_size),
            *(jnp.asarray(cull[g, k]) for k in range(6))))
        tile[pos[~reach]] = num_tiles
    return np.asarray(slot), np.asarray(gauss), tile


@pytest.mark.parametrize("case", K4_EDGE_CASES)
def test_expand_bin_torch_on_edge_cases(case):
    """The plain twin, which the gpu tests hold K4 to bit for bit, equals
    expand_bin's contract written out slot by slot on each of their edge
    cases, with the tiles culled by the JAX package's reachability test."""
    args, kw = expand_case(case)
    offsets, kept, depth_order, rect, n_pairs, grid_x = args
    cull = kw["cull_fields"]
    want = _expand_spec(offsets.numpy(), kept.numpy(), depth_order.numpy(), rect.numpy(),
                        grid_x, kw["tile_size"], kw["num_tiles"],
                        None if cull is None else cull.numpy())
    got = expand.expand_bin_torch(*args, **kw)
    assert got[0].shape == (n_pairs,)
    for name, g, w in zip(("slot", "gauss", "tile"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), (want[2] << 32) | want[0])
    if case == "full_view_rect":  # the whole-view rect is culled tile by tile
        assert (want[2][want[1] == int(depth_order[100])] == kw["num_tiles"]).any()


# ---------------------------------------------------------------------------
# K6: slot-only monotone expand
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_expand_slots_matches_pallas(seed):
    """Exact on every pair position p < total (test_expand_pallas's seed 7
    and two more): the last Gaussian whose offset is <= p."""
    offsets, _, _, _, _, max_pairs, total = random_case(seed, n=500)
    want = np.asarray(expand_slots_pallas(offsets, max_pairs, interpret=True))
    got = expand.expand_slots(T(offsets), max_pairs)
    assert got.dtype == torch.int32 and got.shape == (max_pairs,)
    np.testing.assert_array_equal(got.numpy()[:total], want[:total])


def _scatter_max_cummax(offsets, max_pairs):
    """tests/test_expand_pallas.py's reference slot column."""
    n = offsets.shape[0]
    marks = jnp.zeros(max_pairs, jnp.int32).at[jnp.asarray(offsets)].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    return np.asarray(jax.lax.cummax(marks))


# counts with empty Gaussians leading, in the interior (runs longer than
# the TPU kernel's 768-offset window included) and trailing; and a total
# past max_pairs, whose last offsets are dropped
SLOT_CASES = {
    "leading": [0, 0, 0, 3, 1, 2, 5],
    "interior": [2, 0, 1, 0, 0, 4] + [0] * 1000 + [3, 1],
    "trailing": [1, 2, 3] + [0] * 50,
    "single": [7],
    "overflow": [300, 0, 300, 100],
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_expand_slots_empty_gaussians(case):
    counts = np.asarray(SLOT_CASES[case], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    max_pairs = 512
    total = min(int(counts.sum()), max_pairs)
    want = _scatter_max_cummax(offsets, max_pairs)
    got = expand.expand_slots(T(offsets), max_pairs).numpy()
    np.testing.assert_array_equal(got[:total], want[:total])
    # the last i with offsets[i] <= p, by a search on the host
    p = np.arange(total)
    np.testing.assert_array_equal(got[:total], np.searchsorted(offsets, p, side="right") - 1)


# ---------------------------------------------------------------------------
# K1 / K2: tile blend
# ---------------------------------------------------------------------------


def _blend_inputs(tile_size, seed):
    """Per-pair features and tile ranges of a make_scene view, binned by the
    JAX package (zero drops), plus a random cotangent of the output."""
    means, scales, quats, opac, colors, cam = make_scene(n=300, seed=seed)
    proj = project_gaussians(means, scales, quats, cam, tile_size)
    gx = (cam.width + tile_size - 1) // tile_size
    gy = (cam.height + tile_size - 1) // tile_size
    bins = jax_bin(proj, gx, gy, 2**14, tile_size, opac)
    assert int(bins.n_dropped) == 0
    chans = jnp.concatenate([colors, proj.depths[:, None]], axis=1)
    feats = jnp.concatenate([proj.means2d, proj.conics, opac[:, None], chans], axis=1)
    n_valid = int(bins.tile_ranges[-1])
    pair_feats = np.asarray(feats)[np.asarray(bins.pair_gauss)[:n_valid]]
    ranges = np.asarray(bins.tile_ranges)
    rng = np.random.default_rng(seed + 50)
    g_out = rng.normal(size=(gx * gy, tile_size**2, chans.shape[1] + 1)).astype(np.float32)
    return pair_feats, ranges, g_out, (gx, gy, tile_size, chans.shape[1])


@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_forward_matches_jax(tile_size):
    pair_feats, ranges, _, dims = _blend_inputs(tile_size, seed=0)
    want = np.asarray(blend_jax.blend_forward(jnp.asarray(pair_feats), jnp.asarray(ranges), *dims))
    got = blend.blend_forward(T(pair_feats), T(ranges, torch.int64), *dims).numpy()
    # same chunked rule and the same f32 operations; the sums over a chunk
    # (einsum vs the JAX dot) may round in another order: a few ulp of the
    # output (colours and alpha <= 1, depth ~2.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    assert float(want[..., -1].max()) > 0.5  # the scene really covers pixels


@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_backward_matches_jax(tile_size):
    pair_feats, ranges, g_out, dims = _blend_inputs(tile_size, seed=1)
    out = blend_jax.blend_forward(jnp.asarray(pair_feats), jnp.asarray(ranges), *dims)
    want = np.asarray(blend_jax.blend_backward(
        jnp.asarray(pair_feats), jnp.asarray(ranges), out, jnp.asarray(g_out), *dims))
    got = blend.blend_backward(
        T(pair_feats), T(ranges, torch.int64), T(out), T(g_out), *dims).numpy()
    # per column, relative to the column's largest gradient: the suffix
    # U_tot - prefix and the per-pair sums over pixels are long f32 sums
    # whose rounding order differs between the two frameworks
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(np.abs(got - want).max(axis=0), 1e-5 * scale)


@pytest.mark.parametrize("case", BLEND_CASES)
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_unit_cases_match_jax(tile_size, case):
    """The plain twins on the gpu tests' work-unit cases (a 4000-pair tile
    beside empty ones, ragged counts, an opaque front over one unit)."""
    pf, ranges, g_out, dims = (t.numpy() if torch.is_tensor(t) else t
                               for t in blend_case(case, tile_size))
    out = blend_jax.blend_forward(jnp.asarray(pf), jnp.asarray(ranges), *dims)
    got = blend.blend_forward(T(pf), T(ranges, torch.int64), *dims).numpy()
    np.testing.assert_allclose(got, np.asarray(out), rtol=0, atol=5e-6)
    want = np.asarray(blend_jax.blend_backward(
        jnp.asarray(pf), jnp.asarray(ranges), out, jnp.asarray(g_out), *dims))
    got = blend.blend_backward(T(pf), T(ranges, torch.int64), T(out), T(g_out), *dims).numpy()
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(np.abs(got - want).max(axis=0), 1e-5 * scale)


@pytest.mark.parametrize("tile_size,n_pairs", [(16, 1000), (32, 1000), (32, 1_490_904)])
def test_blend_backward_scratch(tile_size, n_pairs):
    """K2's scratch: the order always; the units' partial rows, stops and
    arrival counters only when a tile has several 16x16 units (tile 32),
    with the shapes and types the kernel indexes them by."""
    num_tiles, n_feats = 257, 10
    scratch = blend.backward_scratch(num_tiles, n_pairs, tile_size, n_feats, "cpu")
    units = {16: 1, 32: 4}[tile_size]
    split = units > 1
    want = dict(partial=((units, n_pairs, n_feats) if split else (0,), torch.float32),
                stops=((num_tiles, units) if split else (0,), torch.int64),
                arrive=((num_tiles,) if split else (0,), torch.int32),
                order=((num_tiles,), torch.int32))
    assert {k: (tuple(t.shape), t.dtype) for k, t in scratch.items()} == want
    if n_pairs == 1_490_904:  # the bench scene: 0.24 GB of partial rows
        assert scratch["partial"].numel() * 4 == 238_544_640


def test_tiles_to_image_matches_jax():
    rng = np.random.default_rng(4)
    gx, gy, ts = 3, 2, 16
    tiled = rng.normal(size=(gx * gy, ts * ts, 5)).astype(np.float32)
    want = np.asarray(blend_jax.tiles_to_image(jnp.asarray(tiled), gx, gy, ts, 30, 45))
    got = blend.tiles_to_image(T(tiled), gx, gy, ts, 30, 45).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K3: monotone segmented sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_segments,n_pairs,f,seed",
    [(300, 2000, 10, 0), (200, 6000, 6, 2), (130, 8000, 4, 3)],
)
def test_segsum_matches_pallas(n_segments, n_pairs, f, seed):
    """Against segsum_monotone_pallas in interpret mode with exact f32
    columns (packed_f=0).  Zero-count segments included, as binning makes
    them for culled Gaussians; the last case has one 6000-row segment."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(n_pairs / n_segments, size=n_segments)
    if seed == 3:
        counts[:] = rng.integers(0, 3, n_segments)
        counts[3] = 6000
    slots = np.repeat(np.arange(n_segments), counts)
    total = len(slots)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:n_segments]
    p_total = (total + 1023) // 1024 * 1024 + 1024
    vals = np.zeros((p_total, f), np.float32)
    vals[:total] = rng.normal(size=(total, f)).astype(np.float32)
    slots_full = np.full(p_total, n_segments, np.int32)
    slots_full[:total] = slots
    want = np.asarray(segsum_monotone_pallas(
        jnp.asarray(vals), jnp.asarray(slots_full), jnp.int32(total), n_segments,
        interpret=True, seg_offsets=jnp.asarray(offsets, jnp.int32), packed_f=0,
    ))
    got = segsum.segsum_monotone(T(vals), T(offsets, torch.int64), T(counts, torch.int64)).numpy()
    # the Pallas kernel sums through a 2-term bf16 split (~2^-18 relative
    # per term, tests/test_segsum_pallas.py); the port sums exact f32.
    # Bound: 2e-5 of each segment's sum of |terms|.
    abs_sum = np.zeros((n_segments, f), np.float32)
    np.add.at(abs_sum, slots, np.abs(vals[:total]))
    np.testing.assert_array_less(np.abs(got - want), 2e-5 * abs_sum + 1e-30)
    np.testing.assert_array_equal(got[counts == 0], 0.0)


@pytest.mark.parametrize("case", SEGSUM_CASES)
def test_segsum_torch_on_edge_cases(case):
    """The plain twin, which the gpu tests hold K3 to, within 1e-5 of each
    sum of |terms| of a float64 sum per segment on each of their edge
    cases, exact zeros for empty segments; and each case is what it says."""
    vals, offsets, counts = segsum_case(case)
    got = segsum.segsum_torch(vals, offsets, counts).numpy()
    v, o, c = vals.numpy().astype(np.float64), offsets.numpy(), counts.numpy()
    prefix = np.concatenate([np.zeros((1, v.shape[1])), np.cumsum(v, axis=0)])
    abs_prefix = np.concatenate([np.zeros((1, v.shape[1])), np.cumsum(np.abs(v), axis=0)])
    want = prefix[o + c] - prefix[o]
    abs_sum = abs_prefix[o + c] - abs_prefix[o]
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * abs_sum + 1e-30)
    np.testing.assert_array_equal(got[c == 0], 0.0)
    assert got.shape == (c.shape[0], 13 if case.startswith("f13") else 10)
    assert int(c.max()) == {"long_segment": 10_000, "all_empty": 0}.get(case, 200)
    assert (vals.data_ptr() % 16 == 0) == (case != "f13_unaligned")


# ---------------------------------------------------------------------------
# The wrappers: plain version only for CPU tensors
# ---------------------------------------------------------------------------


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA entry points check device before anything is built or
    launched; the dispatching wrappers take the plain version only
    because the tensors lie on the CPU."""
    feats = torch.zeros((4, 10))
    ranges = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        blend.blend_forward_cuda(feats, ranges, 2, 2, 16, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segsum.segsum_cuda(feats, torch.zeros(2, dtype=torch.int64),
                           torch.zeros(2, dtype=torch.int64))
    idx = torch.zeros(2, dtype=torch.int64)
    small = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        expand.expand_bin_cuda(idx, idx, idx, torch.zeros((2, 4), dtype=torch.int32), 0, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        expand.expand_slots_cuda(small, 512)
    out = blend.blend_forward(feats, ranges, 2, 2, 16, 4)
    assert out.shape == (4, 256, 5) and not out.any()
