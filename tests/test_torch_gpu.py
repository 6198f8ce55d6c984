"""The port's CUDA kernels on the card, each against its plain torch version
on the same inputs, the training step through them, the structural field
updates on the card against the CPU, and the SD guidance on the card
against its CPU run.

Marked ``gpu``: without a CUDA device every test skips (decided inside the
``cuda`` fixture, never at import).  This file imports neither JAX nor the
JAX package, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from threestudio_3dgs_tpu_torch.ops import camera as pcam
from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
from threestudio_3dgs_tpu_torch.ops import native
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from threestudio_3dgs_tpu_torch.ops.rasterizer import binning, blend, expand, segsum
from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import project_gaussians
from threestudio_3dgs_tpu_torch.utils.profiling import (
    RASTER_KERNELS, TINY_SD_K5_LAUNCHES, TINY_ZERO123_K5_LAUNCHES, k5_float64, k5_inputs,
    k5_tolerance, lookat_c2w, tiny_zero123_card_vs_cpu,
    tiny_sd_card_vs_cpu)

pytestmark = pytest.mark.gpu

PORT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "threestudio_3dgs_tpu_torch",
                           "configs", "gaussian_splatting.yaml")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_scene(device, n=2000, size=96, seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        means=rng.normal(size=(n, 3)) * 0.32,
        scales=np.exp(rng.normal(size=(n, 3)) * 0.5 - 3.0),
        quats=rng.normal(size=(n, 4)),
        opac=rng.uniform(0.05, 0.95, size=n),
        colors=rng.uniform(size=(n, 3)),
    )
    scene = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
    scene["cam"] = pcam.camera_from_c2w(lookat_c2w([0.0, -2.5, 0.3]), 0.9, 0.9, size, size,
                                        device=device)
    return scene


def kernel_inputs(scene, ts, seed=0):
    cam = scene["cam"]
    gx, gy = (cam.width + ts - 1) // ts, (cam.height + ts - 1) // ts
    proj = project_gaussians(scene["means"], scene["scales"], scene["quats"], cam, ts)
    plan = binning.plan_pairs(proj, gx, gy, 2**21, ts, scene["opac"])
    bins = binning.bin_gaussians(proj, gx, gy, 2**21, ts, scene["opac"])
    chans = torch.cat([scene["colors"], proj.depths[:, None]], dim=1)
    feats = torch.cat([proj.means2d, proj.conics, scene["opac"][:, None], chans], dim=1)
    pair_feats = feats[bins.pair_gauss].contiguous()
    gen = torch.Generator(device=pair_feats.device).manual_seed(seed)
    g_out = torch.randn((gx * gy, ts * ts, chans.shape[1] + 1), generator=gen,
                        device=pair_feats.device)
    return plan, bins, pair_feats, g_out, (gx, gy, ts, chans.shape[1])


@torch.no_grad()
def test_expand_kernel_matches_plain(cuda):
    plan = kernel_inputs(make_scene(cuda), 16)[0]
    got = plan.expand(expand.expand_bin_cuda)
    want = plan.expand(expand.expand_bin_torch)
    torch.cuda.synchronize()
    assert got[0].numel() > 0
    for name, g, w in zip(("slot", "gauss", "tile", "key"), got, want):
        assert torch.equal(g, w), name  # integer outputs: exact


# K4's edge cases, made directly with numpy in the layout plan_pairs gives
EXPAND_CASES = ("full_view_rect", "mask_bits", "capacity_drop", "ragged", "straddle",
                "single_pair", "sparse_capacity", "empty_run")


def _random_rects(rng, n, grid, big_share=0.15):
    """n live Gaussians' [x0, y0, w, h] and masks: mostly rects of <= 24
    tiles with a random reachable subset as mask, some larger rects."""
    rects, masks = [], []
    for _ in range(n):
        if rng.uniform() < big_share:
            w, h = int(rng.integers(5, grid + 1)), int(rng.integers(5, grid + 1))
            mask = expand.MASK_NONE
        else:
            w = int(rng.integers(1, 7))
            h = int(rng.integers(1, min(24 // w, grid) + 1))
            mask = int(np.sum((rng.uniform(size=w * h) < 0.7) << np.arange(w * h)))
        rects.append([rng.integers(0, grid - w + 1), rng.integers(0, grid - h + 1), w, h])
        masks.append(mask)
    return np.asarray(rects, np.int64).reshape(-1, 4), np.asarray(masks, np.int64)


def expand_case(case, device="cpu", seed=0):
    """K4's inputs for one edge case, as ``PairPlan.expand`` passes them
    (offsets of the full counts, counts clipped to n_pairs, Gaussian ids in
    depth order, packed rect rows and cull fields in original order):
    ``full_view_rect``, a Gaussian whose rect is every tile of a 512^2 /
    tile-32 view, culled per tile, among 200 others; ``mask_bits``, masks of
    0, 1 and 24 set bits; ``capacity_drop``, 1000 pairs past n_pairs;
    ``ragged``, 1025 one-pair Gaussians without cull (full blocks, each
    staging as many slots as it has pairs, then a 1-pair block);
    ``straddle``, 300-pair rects on a
    32 x 32 grid, so block ranges start inside a Gaussian's pairs;
    ``single_pair``; ``sparse_capacity``, 100 live slots of 1,000,000;
    ``empty_run``, 5000 empty slots between live ones (a block spans more
    slots than it stages).  Returns (args, kwargs) of ``expand_bin``."""
    rng = np.random.default_rng(seed)
    grid, n_before, n_after, clip, cull_on = 16, 0, 0, None, True
    if case == "full_view_rect":
        rects, masks = _random_rects(rng, 200, grid)
        rects[100], masks[100] = [0, 0, grid, grid], expand.MASK_NONE
    elif case == "mask_bits":
        rects, masks = _random_rects(rng, 500, grid)
        rects[10:13] = [2, 3, 6, 4]
        masks[10:13] = [0, 1 << 5, (1 << 24) - 1]
    elif case == "capacity_drop":
        rects, masks = _random_rects(rng, 1500, grid)
        clip = -1000
    elif case == "ragged":
        rects, masks = _random_rects(rng, 1025, grid, big_share=0.0)
        masks = 1 << rng.integers(0, rects[:, 2] * rects[:, 3])
        cull_on = False
    elif case == "straddle":
        grid = 32
        rects = np.tile([[3, 5, 25, 12]], (12, 1))
        masks = np.full(12, expand.MASK_NONE)
    elif case == "single_pair":
        rects, masks = np.asarray([[4, 7, 1, 1]]), np.asarray([1])
        n_after = 10
    elif case == "sparse_capacity":
        rects, masks = _random_rects(rng, 100, grid)
        n_after = 1_000_000 - 100
    elif case == "empty_run":
        rects, masks = _random_rects(rng, 600, grid, big_share=0.05)
        n_before, n_after = 300, 100
    else:
        raise ValueError(case)
    live = len(rects)
    counts_live = np.where(masks == expand.MASK_NONE, rects[:, 2] * rects[:, 3],
                           [bin(int(m) & ((1 << 24) - 1)).count("1") for m in masks])
    counts = np.concatenate([counts_live, np.zeros(n_after, np.int64)])
    if case == "empty_run":  # the run sits after the first n_before live slots
        counts = np.concatenate([counts[:n_before], np.zeros(5000, np.int64), counts[n_before:]])
    n = counts.shape[0]
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum())
    n_pairs = total + clip if clip is not None else total
    kept = np.minimum(counts, np.maximum(n_pairs - offsets, 0))
    depth_order = rng.permutation(n)
    ranks = np.arange(live)  # the depth ranks of the live rects
    if case == "empty_run":
        ranks[n_before:] += 5000
    # rect rows in original order: the live rects', zeros without a mask elsewhere
    rect = np.zeros((n, 4), np.int64)
    rect[:, 3] = expand.MASK_NONE
    rect[depth_order[ranks]] = np.column_stack([rects[:, :3], masks])
    cull = np.column_stack([
        rng.uniform(0, grid * 32, n), rng.uniform(0, grid * 32, n),
        rng.uniform(2e-4, 5e-3, n), rng.uniform(-1e-4, 1e-4, n), rng.uniform(2e-4, 5e-3, n),
        rng.uniform(0.02, 0.99, n),
    ])
    if case == "full_view_rect":
        cull[depth_order[100]] = [256.0, 256.0, 1 / 3600.0, 0.0, 1 / 3600.0, 0.9]
    dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    args = (dev(offsets, torch.int64), dev(kept, torch.int64), dev(depth_order, torch.int64),
            dev(rect, torch.int32), n_pairs, grid)
    kwargs = dict(tile_size=32, num_tiles=grid * grid,
                  cull_fields=dev(cull, torch.float32) if cull_on else None)
    return args, kwargs


@pytest.mark.parametrize("case", EXPAND_CASES)
@torch.no_grad()
def test_expand_kernel_edge_cases(cuda, case):
    """K4 exactly equal to its plain version on each edge case, and K6 on
    the same offsets (int32)."""
    args, kwargs = expand_case(case, cuda)
    native.reset_launches()
    got = expand.expand_bin(*args, **kwargs)
    want = expand.expand_bin_torch(*args, **kwargs)
    torch.cuda.synchronize()
    assert native.LAUNCHES["expand_bin"] == 1
    assert got[0].shape == (args[4],)
    for name, g, w in zip(("slot", "gauss", "tile", "key"), got, want):
        assert torch.equal(g, w), name
    offsets, total = args[0].int(), args[4]
    max_pairs = -(-total // 512) * 512
    slots = expand.expand_slots(offsets, max_pairs)
    assert torch.equal(slots[:total], expand.expand_slots_torch(offsets, max_pairs)[:total])


# pair-count cases for the blend kernels' work units (tile 32: four 16x16
# units a tile, tile 16: one), on a 4 x 3 grid of tiles
BLEND_CASES = ("skewed", "ragged", "opaque_front")


def blend_case(case, ts, device="cpu", seed=0):
    """Pair rows, tile ranges and a cotangent made directly with numpy:
    ``skewed``, one tile of 4000 faint pairs (opacity <= 0.25, so its pixels
    walk about a thousand pairs) beside empty tiles and two light ones;
    ``ragged``, counts that are multiples of no batch (32, 48), group
    (3) or unit size; ``opaque_front``, a 2500-pair tile whose first three
    pairs are near-opaque Gaussians over its top-left 16x16 pixels, so
    those pixels stop within three pairs while the rest of the tile (the
    other units at tile 32) walks on.  Rows are [x, y, conic a, b, c,
    opacity, r, g, b, depth]; returns (pair_feats, tile_ranges, g_out,
    (grid_x, grid_y, ts, 4))."""
    gx, gy = 4, 3
    counts = np.zeros(gx * gy, np.int64)
    if case == "skewed":
        counts[5], counts[6], counts[10] = 4000, 7, 300
    elif case == "ragged":
        counts[:] = [1, 2, 5, 31, 47, 49, 97, 0, 145, 241, 1001, 3]
    elif case == "opaque_front":
        counts[0], counts[1], counts[9] = 2500, 50, 77
    else:
        raise ValueError(case)
    rng = np.random.default_rng(seed)
    max_opacity = 0.25 if case == "skewed" else 0.7
    rows = []
    for t, n in enumerate(counts):
        x0, y0 = (t % gx) * ts, (t // gx) * ts
        sx, sy = rng.uniform(1.5, 8.0, n), rng.uniform(1.5, 8.0, n)
        rho = rng.uniform(-0.6, 0.6, n)
        det = 1.0 - rho**2
        block = np.stack([
            x0 + rng.uniform(-4.0, ts + 4.0, n), y0 + rng.uniform(-4.0, ts + 4.0, n),
            1.0 / (sx**2 * det), -rho / (sx * sy * det), 1.0 / (sy**2 * det),
            rng.uniform(0.02, max_opacity, n), *rng.uniform(size=(3, n)), np.sort(rng.uniform(1.0, 5.0, n)),
        ], axis=1)
        if case == "opaque_front" and t == 0:
            block[:3, :6] = [x0 + 8.0, y0 + 8.0, 1 / 36.0, 0.0, 1 / 36.0, 0.999]
        rows.append(block)
    pair_feats = torch.as_tensor(np.concatenate(rows), dtype=torch.float32, device=device)
    ranges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]), device=device)
    g_out = torch.as_tensor(rng.normal(size=(gx * gy, ts * ts, 5)), dtype=torch.float32,
                            device=device)
    return pair_feats, ranges, g_out, (gx, gy, ts, 4)


def check_blend_kernels(pf, ranges, g_out, dims, view_grid_y=0):
    """K1 and K2 against their plain versions, and bitwise-identical reruns."""
    out = blend.blend_forward_cuda(pf, ranges, *dims, view_grid_y)
    want = blend.blend_forward_torch(pf, ranges, *dims, view_grid_y)
    torch.cuda.synchronize()
    # one pair at a time vs chunked cumulative products: the transmittance
    # rounds apart by a few ulp per pair
    assert float((out - want).abs().max()) <= 2e-4 * max(1.0, float(want.abs().max()))
    assert torch.equal(out, blend.blend_forward_cuda(pf, ranges, *dims, view_grid_y))
    d = blend.blend_backward_cuda(pf, ranges, want, g_out, *dims, view_grid_y)
    d_want = blend.blend_backward_torch(pf, ranges, want, g_out, *dims, view_grid_y)
    torch.cuda.synchronize()
    scale = d_want.abs().amax(dim=0).clamp_min(1e-12)
    assert float(((d - d_want).abs().amax(dim=0) / scale).max()) <= 1e-3
    d2 = blend.blend_backward_cuda(pf, ranges, want, g_out, *dims, view_grid_y)
    assert torch.equal(d, d2)  # no atomics: reruns are bitwise identical


@pytest.mark.parametrize("ts", [16, 32])
@torch.no_grad()
def test_blend_kernels_match_plain(cuda, ts):
    _, bins, pf, g_out, dims = kernel_inputs(make_scene(cuda), ts)
    check_blend_kernels(pf, bins.tile_ranges, g_out, dims)


@pytest.mark.parametrize("case", BLEND_CASES)
@pytest.mark.parametrize("ts", [16, 32])
@torch.no_grad()
def test_blend_kernels_unit_cases(cuda, ts, case):
    """The work-unit split at a skewed tile, ragged pair counts and a unit
    whose pixels stop within three pairs while its tile walks on."""
    check_blend_kernels(*blend_case(case, ts, cuda))


def with_channels(pf, g_out, dims, c, seed=0):
    """The same pairs with C = c channels: rgb alone at 3 (the depth column
    dropped), rgb + depth + c - 4 random extra channels above 4 (SuGaR's
    face normals at 7), and a cotangent of c + 1 channels."""
    gx, gy, ts, _ = dims
    gen = torch.Generator(device=pf.device).manual_seed(seed + c)
    if c == 3:
        pf = pf[:, :9]
    else:
        extra = torch.rand((pf.shape[0], c - 4), generator=gen, device=pf.device) * 2.0 - 1.0
        pf = torch.cat([pf[:, :10], extra], dim=1)
    g_out = torch.randn((gx * gy, ts * ts, c + 1), generator=gen, device=pf.device)
    return pf.contiguous(), g_out, (gx, gy, ts, c)


@pytest.mark.parametrize("case", ("scene",) + BLEND_CASES)
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("c", [3, 7, 8])
@torch.no_grad()
def test_blend_kernels_channel_counts(cuda, c, ts, case):
    """K1/K2 at 3, 7 and 8 channels (kF = 9, 13, 14 floats a pair row; K2's
    reduce-scatter groups of 3, 2 and 2 pairs) against their plain
    versions at the two scenes and the work-unit cases, with bitwise
    reruns, each launch counted under its channel count."""
    if case == "scene":
        _, bins, pf, g_out, dims = kernel_inputs(make_scene(cuda), ts)
        ranges = bins.tile_ranges
    else:
        pf, ranges, g_out, dims = blend_case(case, ts, cuda)
    pf, g_out, dims = with_channels(pf, g_out, dims, c)
    native.reset_launches()
    check_blend_kernels(pf, ranges, g_out, dims)
    assert native.SHAPE_LAUNCHES == {("blend_forward", f"C{c}"): 2,
                                     ("blend_backward", f"C{c}"): 2}


def test_blend_kernels_refuse_other_channel_counts(cuda):
    pf = torch.zeros((4, 15), device=cuda)
    ranges = torch.zeros(5, dtype=torch.int64, device=cuda)
    for c in (2, 9):
        with pytest.raises(ValueError, match="3 to 8 channels"):
            blend.blend_forward_cuda(pf[:, :6 + c], ranges, 2, 2, 16, c)


@torch.no_grad()
def test_segsum_kernel_matches_plain(cuda):
    _, bins, pf, g_out, dims = kernel_inputs(make_scene(cuda), 16)
    d_pairs = blend.blend_backward_cuda(pf, bins.tile_ranges,
                                        blend.blend_forward_cuda(pf, bins.tile_ranges, *dims),
                                        g_out, *dims)
    vals, offs, counts = binning.segsum_inputs(bins, d_pairs)
    got = segsum.segsum_cuda(vals, offs, counts)
    want = segsum.segsum_torch(vals, offs, counts)
    abs_sum = segsum.segsum_torch(vals.abs(), offs, counts)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * abs_sum + 1e-30).all())


# K3's edge cases
SEGSUM_CASES = ("long_segment", "all_empty", "f10", "f13", "f13_unaligned")


def segsum_case(case, device="cpu", seed=0):
    """K3's inputs for one edge case, contiguous segments as
    ``segsum_inputs`` makes them: ``long_segment``, one segment of 10,000
    rows among 3000 empty ones; ``all_empty``, 5000 empty segments;
    ``f10`` / ``f13``, a training view's layout (4096 live segments of
    about 7 rows, a few of 200, then 16,000 empty ones of the capacity) at
    F = 10 and at F = 13, the ``pred_normal`` width; ``f13_unaligned``, the
    same rows as a view one row into a larger tensor (52 bytes, not 16-byte
    aligned).  Returns (vals, offsets, counts)."""
    rng = np.random.default_rng(seed)
    f = 13 if case.startswith("f13") else 10
    if case == "long_segment":
        counts = np.zeros(3000, np.int64)
        counts[1234] = 10_000
    elif case == "all_empty":
        counts = np.zeros(5000, np.int64)
    elif case in ("f10", "f13", "f13_unaligned"):
        counts = np.zeros(20_096, np.int64)
        counts[:4096] = rng.poisson(6.7, 4096)
        counts[rng.integers(0, 4096, 5)] = 200
    else:
        raise ValueError(case)
    rows = max(int(counts.sum()), 16)
    vals = rng.normal(size=(rows + 1, f)).astype(np.float32)
    vals = torch.as_tensor(vals, device=device)
    vals = vals[1:] if case == "f13_unaligned" else vals[:-1].contiguous()
    offsets = torch.as_tensor(np.cumsum(counts) - counts, device=device)
    return vals, offsets, torch.as_tensor(counts, device=device)


@pytest.mark.parametrize("case", SEGSUM_CASES)
@torch.no_grad()
def test_segsum_kernel_edge_cases(cuda, case):
    """K3 within 1e-5 of each sum of |terms| of its plain version, exact
    zeros for empty segments, and bitwise-identical reruns."""
    vals, offs, counts = segsum_case(case, cuda)
    native.reset_launches()
    got = segsum.segsum_monotone(vals, offs, counts)
    want = segsum.segsum_torch(vals, offs, counts)
    abs_sum = segsum.segsum_torch(vals.abs(), offs, counts)
    torch.cuda.synchronize()
    assert native.LAUNCHES["segsum_monotone"] == 1
    assert bool(((got - want).abs() <= 1e-5 * abs_sum + 1e-30).all())
    assert not bool(got[counts == 0].any())
    assert torch.equal(got, segsum.segsum_cuda(vals, offs, counts))


def test_rasterize_on_card_matches_cpu(cuda):
    """The whole rasterize (kernels on the card) against the plain versions
    on the CPU: image and gradients."""
    scene = make_scene(cuda, n=1500, size=64, seed=3)
    results = []
    for device in (cuda, torch.device("cpu")):
        leaves = [scene[k].detach().to(device).requires_grad_(True)
                  for k in ("means", "scales", "quats", "opac", "colors")]
        cam = pcam.camera_from_c2w(lookat_c2w([0.0, -2.5, 0.3]), 0.9, 0.9, 64, 64,
                                   device=device)
        native.reset_launches()
        out = rasterize(*leaves[:4], cam, torch.ones(3, device=device), colors=leaves[4],
                        config=RasterizeConfig(tile_size=16))
        loss = out["image"].sum() + out["alpha"].sum() + out["depth"].sum()
        grads = torch.autograd.grad(loss, leaves)
        results.append((out, grads, dict(native.LAUNCHES)))
    (out_c, g_c, launches), (out_p, g_p, no_launches) = results
    assert all(launches[k] == 1 for k in RASTER_KERNELS), launches
    assert not any(no_launches.values()), no_launches
    assert out_c["n_pairs"] == out_p["n_pairs"] and out_c["n_dropped"] == 0
    for name in ("image", "alpha", "depth"):
        diff = (out_c[name].detach().cpu() - out_p[name].detach()).abs()
        assert float(diff.max()) <= 6e-4, name
    for gc, gp in zip(g_c, g_p):
        scale = float(gp.abs().max())
        assert float((gc.cpu() - gp).abs().max()) <= 1e-3 * scale


def test_training_steps_on_card(cuda, tmp_path):
    from threestudio_3dgs_tpu_torch import launch

    native.reset_launches()
    trainer = launch.main([
        "--config", PORT_CONFIG, "--train", f"exp_root_dir={tmp_path}",
        "trainer.max_steps=2", "trainer.val_check_interval=0",
        "data.width=128", "data.height=128", "data.batch_size=2",
        "system.geometry.init_num_pts=512", "system.geometry.capacity=2048",
        "system.guidance_type=fake-sds-guidance",
        "data.eval_height=128", "data.eval_width=128", "data.n_test_views=4",
    ])
    assert trainer.state.gauss.params.xyz.is_cuda
    assert all(np.isfinite(row["train/loss_total"]) for row in trainer.metrics_log)
    # step 0 renders its 2 views one by one; the YAML's adaptive capacity
    # shrinks to 256 Ki a view after it, so step 1 takes the single pass
    # (one launch each); then 4 test renders (forward only: K1 and K4)
    assert native.LAUNCHES["blend_backward"] == native.LAUNCHES["segsum_monotone"] == 3
    assert native.LAUNCHES["blend_forward"] == native.LAUNCHES["expand_bin"] == 7
    assert all(native.SHAPE_LAUNCHES[(k, "stacked")] == 1 for k in RASTER_KERNELS)
    assert native.LAUNCHES["flash_attention_forward"] == 0  # fake guidance: no UNet


def ring_cameras(device, b, size):
    """b cameras of one size on a ring around the scene."""
    cams = []
    for v in range(b):
        ang = 2.0 * np.pi * v / b
        cams.append(pcam.camera_from_c2w(
            lookat_c2w([2.5 * np.sin(ang), -2.5 * np.cos(ang), 0.3 + 0.1 * v]), 0.9, 0.9,
            size, size, device=device))
    return cams


@pytest.mark.parametrize("channels", [4, 7])
@pytest.mark.parametrize("size", [128, 512])
@torch.no_grad()
def test_stacked_kernels_match_plain(cuda, size, channels):
    """K1-K4 on the single pass's grid, 4 views stacked as tile rows (tile
    32, view_grid_y = size / 32; C = 7 with 3 random extra channels, SuGaR's
    and pred_normal's width): K4's pair lists exactly, K1/K2 to the plain
    twins' bounds with bitwise reruns, K3 to 1e-5 of each column's sum of
    |terms|; every launch tagged stacked."""
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    scene = make_scene(cuda, n=4000, size=size, seed=size + channels)
    scene.update(cam=None, alive=None, tile_size=32)
    if channels == 7:
        gen = torch.Generator(device=cuda).manual_seed(channels)
        scene["extra"] = torch.rand((4000, 3), generator=gen, device=cuda) * 2.0 - 1.0
    native.reset_launches()
    inp = view_inputs(scene, seed=channels, cameras=ring_cameras(cuda, 4, size))
    gy = size // 32
    assert inp["view_grid_y"] == gy and inp["dims"] == (size // 32, 4 * gy, 32, channels)
    ranges = inp["bins"].tile_ranges
    per_view = (ranges[gy * (size // 32)::gy * (size // 32)] - ranges[:-1:gy * (size // 32)])
    assert bool((per_view > 0).all())  # every view holds pairs
    got = inp["plan"].expand(expand.expand_bin_cuda)
    want = inp["plan"].expand(expand.expand_bin_torch)
    for name, g, w in zip(("slot", "gauss", "tile", "key"), got, want):
        assert torch.equal(g.long(), w.long()), name
    check_blend_kernels(inp["pair_feats"], ranges, inp["g_out"], inp["dims"], gy)
    vals, offs, counts = inp["seg"]
    got = segsum.segsum_cuda(vals, offs, counts)
    want = segsum.segsum_torch(vals, offs, counts)
    abs_sum = segsum.segsum_torch(vals.abs(), offs, counts).amax(dim=0).clamp_min(1e-30)
    assert float(((got - want).abs().amax(dim=0) / abs_sum).max()) <= 1e-5
    for k in ("blend_forward", "blend_backward", "expand_bin"):
        assert native.SHAPE_LAUNCHES[(k, "stacked")] == native.LAUNCHES[k], k


def test_batched_render_on_card_matches_loop(cuda):
    """rasterize_batched on the card (4 views at 128^2) against the per-view
    rasterize on the card, bit for bit forward and to 2e-4 x scale in the
    gradients, and against its own CPU run (test_rasterize_on_card_matches_
    cpu's bounds)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import rasterize_batched

    scene = make_scene(cuda, n=1500, size=128, seed=9)
    names = ("means", "scales", "quats", "opac", "colors")
    cfg = RasterizeConfig(tile_size=16, max_pairs=1 << 18)
    runs = {}
    for how, device in (("batched", cuda), ("loop", cuda), ("cpu", torch.device("cpu"))):
        leaves = [scene[k].detach().to(device).requires_grad_(True) for k in names]
        cams = ring_cameras(device, 4, 128)
        bg = torch.tensor([0.2, 0.4, 0.6], device=device)
        native.reset_launches()
        if how == "loop":
            outs = [rasterize(*leaves[:4], cam, bg, colors=leaves[4], config=cfg) for cam in cams]
            out = {k: torch.stack([o[k] for o in outs]) for k in ("image", "alpha", "depth")}
        else:
            out = rasterize_batched(*leaves[:4], cams, bg, colors=leaves[4], config=cfg)
        loss = (out["image"] * out["image"]).sum() + out["alpha"].sum() + out["depth"].sum()
        runs[how] = (out, torch.autograd.grad(loss, leaves), dict(native.SHAPE_LAUNCHES))
    (out_b, g_b, tags), (out_l, g_l, _), (out_c, g_c, _) = (runs[k] for k in
                                                            ("batched", "loop", "cpu"))
    assert all(tags[(k, "stacked")] == 1 for k in RASTER_KERNELS), tags
    assert out_b["n_dropped"] == 0 and out_b["n_pairs"] == out_c["n_pairs"]
    for name in ("image", "alpha", "depth"):
        assert torch.equal(out_b[name], out_l[name]), name
        assert float((out_b[name].detach().cpu() - out_c[name].detach()).abs().max()) <= 6e-4
    for gb, gl, gc in zip(g_b, g_l, g_c):
        assert float((gb - gl).abs().max()) <= 2e-4 * max(1.0, float(gl.abs().max()))
        assert float((gb.cpu() - gc).abs().max()) <= 1e-3 * float(gc.abs().max())


@torch.no_grad()
def test_expand_slots_kernel_matches_plain(cuda):
    """K6 on a scene's depth-ordered pair offsets (culled Gaussians sort to
    an empty tail), on offsets with a long interior run of empty
    Gaussians, and at the bench scene's scale (1M Gaussians, 1.49 pairs
    each, an empty tail) with runs of 20,000 empty Gaussians, each a
    window wider than a block's staged offsets: exact on every p < total."""
    plan = kernel_inputs(make_scene(cuda), 16)[0]
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, 5000)
    counts[100:2100] = 0
    wide = rng.poisson(1.49, 1_000_000)
    wide[100_000:120_000] = wide[500_000:520_000] = wide[700_000:] = 0
    cases = [(plan.offsets.int(), plan.n_pairs)] + [
        (torch.as_tensor(np.cumsum(c) - c, dtype=torch.int32, device=cuda), int(c.sum()))
        for c in (counts, wide)]
    for offsets, total in cases:
        max_pairs = -(-total // 512) * 512
        native.reset_launches()
        got = expand.expand_slots(offsets, max_pairs)
        want = expand.expand_slots_torch(offsets, max_pairs)
        torch.cuda.synchronize()
        assert native.LAUNCHES["expand_slots"] == 1
        assert total > 0 and torch.equal(got[:total], want[:total])


def test_structural_ops_on_card_match_cpu(cuda):
    """Prune, opacity reset, cap-prune and densify (clones and splits, the
    same draws) on the card against the same ops on the CPU."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.models.convert import to_numpy

    cfg = gf.GaussianFieldConfig(init_num_pts=3000, capacity=8192, sh_degree=1)
    cpu = gf.init_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cpu.xyz_grad_accum = torch.rand(cfg.capacity, generator=gen) * 0.02
    cpu.denom = (torch.rand(cfg.capacity, generator=gen) * 3).floor()
    cpu.params.scaling += torch.randn(cpu.params.scaling.shape, generator=gen)
    cpu.params.opacity += torch.randn(cpu.params.opacity.shape, generator=gen) * 3
    draws = tuple(torch.randn((cfg.capacity, 3), generator=gen) for _ in range(2))
    scores = torch.rand(cfg.capacity, generator=gen)

    def ops(state):
        state = gf.prune_op(state, 0.05, prune_big_points=True)
        state = gf.reset_opacity_op(state)
        state = gf.densify_op(state, 0.004, 0.02, draws=draws)
        return state, gf.cap_prune_op(state, 2000, draws=scores)

    want = [to_numpy(s) for s in ops(cpu)]
    card = dataclasses.replace(
        cpu, params=gf.GaussianParams(**{k: v.to(cuda) for k, v in cpu.params.as_dict().items()}),
        adam=gf.init_adam({k: v.to(cuda) for k, v in cpu.params.as_dict().items()}),
        alive=cpu.alive.to(cuda), max_radii2d=cpu.max_radii2d.to(cuda),
        xyz_grad_accum=cpu.xyz_grad_accum.to(cuda), denom=cpu.denom.to(cuda))
    got = [to_numpy(s) for s in ops(card)]
    assert int(want[0]["alive"].sum()) > 2000 and int(want[1]["alive"].sum()) == 2000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["alive"], w["alive"])
        for k, v in w["params"].items():
            # exp, log and sigmoid (the opacity reset, the split scales) on
            # the card and the CPU round a few ulps apart
            np.testing.assert_allclose(g["params"][k], v, rtol=4e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bh,n,rising", [
    (40, 4096, False), (80, 1024, False),  # the SD 2.1-base UNet's shapes (CFG batch 8)
    (40, 4096, True),                      # the running max grows in every key tile
    (40, 1000, False),                     # ragged: a partial last key and query tile
    (10, 16384, False),                    # MVDream: 4 views folded, CFG batch 2 x 5 heads
], ids=["level0", "level1", "rising_max", "ragged", "multiview"])
@torch.no_grad()
def test_flash_attention_kernel_matches_plain(cuda, bh, n, rising):
    """K5 in bf16 (the wgmma kernel), to 2^-6 of max|plain| (two bf16 ulps
    at the largest output); and f32 (the split-bf16 kernel) at 2e-5
    (k5_tolerance)."""
    q, k, v = k5_inputs(bh, n, torch.bfloat16, seed=0, rising=rising)
    got = fa.flash_bhnd(q, k, v, 0.125)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= k5_tolerance(want)
    q, k, v = k5_inputs(8, n // 4, torch.float32, seed=1, rising=rising)
    got = fa.flash_bhnd(q, k, v, 0.125)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= k5_tolerance(want)


@torch.no_grad()
def test_flash_attention_kernel_deterministic(cuda):
    q, k, v = k5_inputs(40, 4096, torch.bfloat16, seed=2)
    native.reset_launches()
    a = fa.flash_bhnd(q, k, v, 0.125)
    b = fa.flash_bhnd(q, k, v, 0.125)
    assert native.LAUNCHES["flash_attention_forward"] == 2
    assert torch.equal(a, b)


@torch.no_grad()
def test_flash_attention_bh_limit_is_f32_only(cuda):
    """Both kernels walk a 1-D grid of units, so neither has a grid-y limit
    on bh: bf16 at bh = 70,000 and f32 at bh = 65,536 (past the 65,535 of
    the f32 kernel before the split one) match the plain version."""
    q, k, v = k5_inputs(70000, 64, torch.bfloat16, seed=3)
    got = fa.flash_bhnd(q, k, v, 0.125)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= k5_tolerance(want)
    q, k, v = k5_inputs(65536, 64, torch.float32, seed=4)
    got = fa.flash_bhnd(q, k, v, 0.125)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= k5_tolerance(want)


@torch.no_grad()
def test_flash_attention_bf16_other_head_dim_raises(cuda):
    """bf16 with d = 264 (past K5's four 64-column boxes): the wrapper
    raises before any launch, and the C entry point refuses it instead of
    running another kernel."""
    d = 264
    q, k, v = (torch.randn((8, 1024, d), device=cuda, dtype=torch.bfloat16) for _ in range(3))
    native.reset_launches()
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_bhnd(q, k, v, d**-0.5)
    assert native.LAUNCHES["flash_attention_forward"] == 0
    out = torch.full_like(q, 7.0)
    err = native.library("flash_attention").flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 8, 1024, d, d**-0.5, 1,
        native.stream_handle(q.device))
    torch.cuda.synchronize()
    assert err == 1 and bool((out == 7.0).all())  # cudaErrorInvalidValue, nothing written


@pytest.mark.parametrize("d", [72, 80, 128, 160, 192, 256])
@torch.no_grad()
def test_flash_attention_wide_head_dims(cuda, d):
    """Head dims above 64 (two to four 64-column boxes, the last zero-filled
    past d; Stable Zero123's levels 1-2 at d = 80 and 160): bf16 at
    (64, 1024, d) and a ragged (16, 1000, d), and f32 up to d = 192 at
    (16, 1024, d), against the plain twin (k5_tolerance), one launch each,
    counted under its shape; through the C entry point into an output with
    64 guard elements after it."""
    lib = native.library("flash_attention")
    cases = [(64, 1024, torch.bfloat16, 40), (16, 1000, torch.bfloat16, 41)]
    if d <= fa.MAX_HEAD_DIM[torch.float32]:
        cases.append((16, 1024, torch.float32, 42))
    for bh, n, dtype, seed in cases:
        q, k, v = k5_inputs(bh, n, dtype, seed=seed + d, d=d)
        scale = d**-0.5
        native.reset_launches()
        got = fa.flash_bhnd_cuda(q, k, v, scale)
        assert native.SHAPE_LAUNCHES[("flash_attention_forward", fa.shape_tag(bh, n, d))] == 1
        want = fa.flash_bhnd_torch(q, k, v, scale)
        guarded = torch.full((q.numel() + 64,), 7.0, dtype=dtype, device=cuda)
        bf16 = dtype == torch.bfloat16
        scratch = None if bf16 else torch.empty(9 * q.numel(), dtype=torch.bfloat16, device=cuda)
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), guarded.data_ptr(),
            None if scratch is None else scratch.data_ptr(), bh, n, d, scale, int(bf16),
            native.stream_handle(q.device))
        torch.cuda.synchronize()
        assert err == 0
        assert got.shape == (bh, n, d) and bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) <= k5_tolerance(want), (bh, n, dtype)
        assert torch.equal(guarded[: q.numel()].reshape(bh, n, d), got)
        assert bool((guarded[q.numel():] == 7.0).all())


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48, 56, 64])
@torch.no_grad()
def test_flash_attention_head_dims(cuda, d):
    """Every head dim K5 takes (d <= 64, d % 8 == 0, zero-filled to 64
    columns by its TMA boxes): bf16 at (64, 1024, d) (Stable Zero123's
    level 0 at d = 40) and a ragged (16, 1000, d), and f32 at (16, 1024, d),
    against the plain twin (k5_tolerance); and through the C entry point
    into an output with 64 guard elements after it, which a store past the
    last row's d columns would reach."""
    lib = native.library("flash_attention")
    for bh, n, dtype, seed in ((64, 1024, torch.bfloat16, 30), (16, 1000, torch.bfloat16, 31),
                               (16, 1024, torch.float32, 32)):
        q, k, v = k5_inputs(bh, n, dtype, seed=seed + d, d=d)
        scale = d**-0.5
        got = fa.flash_bhnd_cuda(q, k, v, scale)
        want = fa.flash_bhnd_torch(q, k, v, scale)
        guarded = torch.full((q.numel() + 64,), 7.0, dtype=dtype, device=cuda)
        bf16 = dtype == torch.bfloat16
        scratch = None if bf16 else torch.empty(9 * q.numel(), dtype=torch.bfloat16, device=cuda)
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), guarded.data_ptr(),
            None if scratch is None else scratch.data_ptr(), bh, n, d, scale, int(bf16),
            native.stream_handle(q.device))
        torch.cuda.synchronize()
        assert err == 0
        assert got.shape == (bh, n, d) and bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) <= k5_tolerance(want), (bh, n, dtype)
        assert torch.equal(guarded[: q.numel()].reshape(bh, n, d), got)
        assert bool((guarded[q.numel():] == 7.0).all())


def test_sd_guidance_on_card_matches_cpu(cuda, tmp_path):
    """A tiny random SD directory: the guidance's loss and its gradient
    w.r.t. rgb on the card against the same call on the CPU, f32 weights,
    the same draws (1e-4 relative; cuDNN and the CPU sum in other orders).
    Its level-0 self-attention (32^2 = 1024 latent tokens, head dim 64)
    goes through K5 on the card and through the einsum on the CPU."""
    results = tiny_sd_card_vs_cpu(str(tmp_path))
    (loss_c, grad_c, k5_card), (loss_p, grad_p, k5_cpu) = results["cuda"], results["cpu"]
    assert (k5_card, k5_cpu) == (TINY_SD_K5_LAUNCHES, 0)
    assert np.isfinite(loss_c) and loss_c == pytest.approx(loss_p, rel=1e-4)
    assert float((grad_c - grad_p).norm() / grad_p.norm()) <= 1e-4


# ---------------------------------------------------------------------------
# The lit and multi-view slice: K5 in f32 at MVDream's shapes, CLIP, the
# renderer variants' training steps, the MVDream guidance
# ---------------------------------------------------------------------------

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "threestudio_3dgs_tpu_torch", "configs")


@pytest.mark.parametrize("bh,n,rising", [(10, 4096, False), (20, 1024, False), (10, 4096, True)],
                         ids=["level0", "level1", "level0_rising"])
@torch.no_grad()
def test_flash_attention_f32_mvdream_shapes(cuda, bh, n, rising):
    """K5's split-bf16 f32 kernel at the MVDream UNet's self-attention
    shapes (256^2 renders, 4 views folded, CFG batch 8), to 2e-5 of the
    plain twin, one launch counted under its shape.  At level 0 with keys
    in rising norm (logits of about +-30) the plain twin in f32 is itself
    1.6-2.5e-5 from the function's float64 value on the card (cuBLAS's
    rounding of raw scores up to 240), so there K5 is held to 2e-5 of the
    float64 value and to no further from it than the plain twin is."""
    q, k, v = k5_inputs(bh, n, torch.float32, seed=5, rising=rising)
    native.reset_launches()
    got = fa.flash_bhnd(q, k, v, 0.125)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert native.SHAPE_LAUNCHES == {("flash_attention_forward", fa.shape_tag(bh, n, 64)): 1}
    if not rising:
        assert float((got - want).abs().max()) <= k5_tolerance(want) == 2e-5
        return
    exact = k5_float64(q, k, v, 0.125)
    err = float((got.double() - exact).abs().max())
    assert err <= k5_tolerance(want) == 2e-5
    assert err <= float((want.double() - exact).abs().max())


def bf16_planes(x, count=3):
    """x as ``count`` bf16 values (held in f32), each the round-to-nearest
    bf16 of what the earlier ones leave: the split of K5's f32 kernel."""
    planes, rest = [], x
    for _ in range(count):
        planes.append(rest.to(torch.bfloat16).float())
        rest = rest - planes[-1]
    return planes


# the products b_i . b_j of K5's f32 kernel (i + j <= 2), smallest first
SPLIT_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


@pytest.mark.parametrize("bh,n", [(8, 1024), (10, 4096)], ids=["n1024", "n4096"])
@torch.no_grad()
def test_f32_split_arithmetic_on_tensor_cores(cuda, bh, n):
    """The split arithmetic of K5's f32 kernel with the card's own
    tensor-core sums, keys in rising norm: 64-key tiles, S and P V each one
    product of the six plane pairs laid side by side along the reduced
    axis.  The planes are bf16 values, exact in TF32, so a TF32 matmul
    multiplies them exactly and sums them as the tensor cores do; the
    result stays within k5_tolerance of the plain twin (cuBLAS in f32)."""
    q, k, v = k5_inputs(bh, n, torch.float32, seed=1, rising=True)
    want = fa.flash_bhnd_torch(q, k, v, 0.125)

    def split_product(a, b):  # a (bh, m, r), b (bh, r, c), both f32
        pa, pb = bf16_planes(a), bf16_planes(b)
        return torch.matmul(torch.cat([pa[i] for i, _ in SPLIT_TERMS], -1),
                            torch.cat([pb[j] for _, j in SPLIT_TERMS], -2))

    def attend(product):
        m = torch.full((bh, n, 1), -float("inf"), device=cuda)
        l, o = torch.zeros((bh, n, 1), device=cuda), torch.zeros_like(q)
        for j in range(0, n, 64):
            s = product(q, k[:, j:j + 64].transpose(1, 2)) * 0.125
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + product(p, v[:, j:j + 64])
            m = m_new
        return o / l

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        split = float((attend(split_product) - want).abs().max())
        one_pass = float((attend(torch.matmul) - want).abs().max())
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"split arithmetic on the tensor cores ({bh}, {n}, 64) rising: max |diff| {split:.3e}; "
          f"one TF32 pass {one_pass:.3e}")
    # the one-pass run shows that the matmuls ran in TF32 on the tensor cores
    assert split <= k5_tolerance(want) < one_pass


def test_clip_on_card_matches_cpu(cuda, tmp_path):
    """The CLIP text encoder of a tiny random directory on the card against
    the CPU, three prompts, to 1e-4 of max(1, max|CPU|)."""
    from threestudio_3dgs_tpu_torch.guidance import clip
    from threestudio_3dgs_tpu_torch.guidance.tokenizer import write_tokenizer

    write_tokenizer(str(tmp_path / "tokenizer"), "a photo of a hamburger, front view", 50,
                    pad_token="!")
    clip.write_random_text_encoder(str(tmp_path / "text_encoder"), clip.CLIPTextConfig(
        vocab_size=700, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, hidden_act="gelu"), seed=0, device="cpu")
    on_card, on_cpu = clip.PromptEncoder(str(tmp_path), cuda), clip.PromptEncoder(str(tmp_path))
    for prompt in ("a hamburger", "A photo of a hamburger, front view!", "x " * 100):
        card, cpu = on_card(prompt), on_cpu(prompt)
        assert card.shape == (77, 64) and np.isfinite(card).all()
        assert np.abs(card - cpu).max() <= 1e-4 * max(1.0, np.abs(cpu).max())


@pytest.mark.parametrize("yaml", ["shading", "background", "mvdream", "imagedream"])
def test_lit_training_steps_on_card(cuda, tmp_path, yaml):
    """Two steps of each of this slice's YAMLs on the card at 128^2 with
    fake or analytic guidance (the lit branch from step 1): finite losses,
    every raster kernel launched, the background MLP trained."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.systems.base import flatten_extra

    guidance = ([] if yaml in ("mvdream", "imagedream")
                else ["system.guidance_type=fake-sds-guidance"])
    native.reset_launches()
    trainer = launch.main([
        "--config", os.path.join(CONFIG_DIR, f"gaussian_splatting_{yaml}.yaml"), "--train",
        f"exp_root_dir={tmp_path}", "trainer.max_steps=2", "trainer.val_check_interval=0",
        "data.width=128", "data.height=128", "system.geometry.init_num_pts=512",
        "system.geometry.capacity=2048", "system.material.ambient_only_steps=1",
        "system.background.random_aug=false",
        "data.eval_height=128", "data.eval_width=128", "data.n_test_views=2",
    ] + guidance)
    assert all(np.isfinite(row["train/loss_total"]) for row in trainer.metrics_log)
    assert all(native.LAUNCHES[k] > 0 for k in RASTER_KERNELS)
    init = flatten_extra(trainer.system.init_state(trainer.cfg.seed).extra_params)
    for k, v in flatten_extra(trainer.state.extra_params).items():
        assert v.is_cuda and float((v - init[k]).abs().max()) > 0, k


def test_mvdream_guidance_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """A tiny random MVDream directory (head dim 64 at level 0, so the
    4-view fold of 16^2 latents is a 1024-token self-attention that takes
    K5's f32 kernel on the card): the recon-SDS loss and its gradient
    w.r.t. rgb on the card against the CPU, f32, the same draws (1e-4
    relative)."""
    import threestudio_3dgs_tpu_torch.diffusion as pdiff
    from threestudio_3dgs_tpu_torch.diffusion import convert, unet, vae
    from threestudio_3dgs_tpu_torch.guidance.mvdream import MultiviewDiffusionGuidance

    ucfg = unet.UNet2DConditionConfig(
        block_out_channels=(64, 128), attention_head_dim=(1, 2), cross_attention_dim=48,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), norm_groups=8,
        num_views=4, camera_embed_dim=16)
    vcfg = vae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)
    monkeypatch.setattr(pdiff, "MVDREAM_UNET", ucfg)
    monkeypatch.setattr(pdiff, "SD_VAE", vcfg)
    convert.write_random_checkpoint(str(tmp_path), ucfg, vcfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)
    emb = rng.normal(size=(77, 48)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(4, 3))
    draws = {"t": torch.tensor([300]),
             "noise": torch.tensor(rng.normal(size=(4, 4, 16, 16)).astype(np.float32)),
             "latent_noise": torch.tensor(rng.normal(size=(4, 4, 16, 16)).astype(np.float32))}

    class Prompt:
        def get_text_embeddings(self, elevation=None, azimuth=None):
            return emb

    results = {}
    for device in ("cuda", "cpu"):
        guidance = MultiviewDiffusionGuidance(
            {"pretrained_model_name_or_path": str(tmp_path), "image_size": 32}, device=device)
        x = torch.tensor(rgb, device=device, requires_grad=True)
        native.reset_launches()
        out = guidance(x, Prompt(), {"c2w": c2w}, draws=draws)
        out["loss_sds"].backward()
        results[device] = (float(out["loss_sds"].detach()), x.grad.cpu(),
                           dict(native.SHAPE_LAUNCHES))
    (loss_c, grad_c, k5_c), (loss_p, grad_p, k5_p) = results["cuda"], results["cpu"]
    assert k5_c == {("flash_attention_forward", fa.shape_tag(2, 1024, 64)): 5} and k5_p == {}
    assert np.isfinite(loss_c) and loss_c == pytest.approx(loss_p, rel=1e-4)
    assert float((grad_c - grad_p).norm() / grad_p.norm()) <= 1e-4


# ---------------------------------------------------------------------------
# The image-to-3D slice: the Zero123 guidance (K5 at d = 40), the zero123
# YAML and its warm starts
# ---------------------------------------------------------------------------


def test_zero123_guidance_on_card_matches_cpu(cuda, tmp_path):
    """A tiny random ldm .ckpt (320 channels and 8 heads at level 0, so its
    32^2 = 1024-token self-attention runs K5's f32 kernel at d = 40 on the
    card): after prepare_embeddings, the SDS loss and its gradient w.r.t.
    rgb on the card against the CPU, f32, the same draws (1e-4 relative)."""
    results = tiny_zero123_card_vs_cpu(str(tmp_path))
    (loss_c, grad_c, k5_card), (loss_p, grad_p, k5_cpu) = results["cuda"], results["cpu"]
    assert (k5_card, k5_cpu) == (TINY_ZERO123_K5_LAUNCHES, 0)
    assert np.isfinite(loss_c) and loss_c == pytest.approx(loss_p, rel=1e-4)
    assert float((grad_c - grad_p).norm() / grad_p.norm()) <= 1e-4


def test_zero123_training_and_warm_start_on_card(cuda, tmp_path):
    """Two steps of gaussian_splatting_zero123.yaml on the card at 128^2
    (the synthetic reference; the analytic prior, so no K5), then a warm
    start from its checkpoint whose field equals the trained one."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf

    common = [f"exp_root_dir={tmp_path}", "data.image_path=", "data.height=128",
              "data.width=128", "data.random_camera.height=128", "data.random_camera.width=128",
              "data.random_camera.eval_height=128", "data.random_camera.eval_width=128",
              "data.random_camera.n_test_views=2", "system.geometry.init_num_pts=512",
              "system.geometry.capacity=2048"]
    config = os.path.join(CONFIG_DIR, "gaussian_splatting_zero123.yaml")
    native.reset_launches()
    trainer = launch.main(["--config", config, "--train", "trainer.max_steps=2",
                           "trainer.val_check_interval=0"] + common)
    assert all(np.isfinite(row["train/loss_total"]) for row in trainer.metrics_log)
    assert all(native.LAUNCHES[k] > 0 for k in RASTER_KERNELS)
    assert native.LAUNCHES["flash_attention_forward"] == 0
    ckpt = os.path.join(trainer.save_dir, "ckpts", "last.ckpt.npz")
    warm = gf.GaussianField(dict(trainer.cfg.system["geometry"], geometry_convert_from=ckpt),
                            device=cuda).init_state()
    assert torch.equal(warm.alive, trainer.state.gauss.alive)
    for k, v in trainer.state.gauss.params.as_dict().items():
        assert torch.equal(getattr(warm.params, k), v), k


def test_gs4d_steps_on_card_match_cpu(cuda, tmp_path):
    """Two steps of gs4d_motion.yaml (polynomial motion, the ref-frame
    anchor, the lite ARAP on from step 0 at a fixed time) on the card and
    on the CPU from one initial field, at 64^2 with 3 frames: the losses
    to 1e-3 relative, 99% of the alive rows of each field within 2% of its
    learning rate (a row at a discontinuity of the rasterizer may take
    another gradient from states that differ by rounding), every raster
    kernel launched, no K5 (analytic prior)."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.models.optim import AdamState
    from threestudio_3dgs_tpu_torch.systems.base import SystemState
    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    overrides = [
        "trainer.max_steps=2", "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
        "data.height=64", "data.width=64", "data.random_camera.height=64",
        "data.random_camera.width=64", "data.random_camera.batch_size=1",
        "data.video_length=3", "data.num_frames=3", "system.geometry.init_num_pts=512",
        "system.geometry.capacity=2048", "system.renderer.tile_size=16",
        "system.guidance_zero123.min_step_percent=0.5",
        "system.guidance_zero123.max_step_percent=0.5",
        "system.loss.lambda_lite_arap_reg=100.0", "system.freq.update_arap=1",
    ]
    config = os.path.join(CONFIG_DIR, "gs4d_motion.yaml")
    trainers = [Trainer(load_config(config, overrides + [f"exp_root_dir={tmp_path / d.type}"]),
                        device=d) for d in (torch.device("cpu"), cuda)]
    init = trainers[0].system.init_state(0).gauss

    def moved(t):
        return t.to(cuda).clone() if isinstance(t, torch.Tensor) else t

    trainers[0].state = SystemState(gauss=init)
    trainers[1].state = SystemState(gauss=gf.GaussianState(
        params=type(init.params)(**{k: moved(v) for k, v in init.params.as_dict().items()}),
        adam=AdamState({k: moved(v) for k, v in init.adam.mu.items()},
                       {k: moved(v) for k, v in init.adam.nu.items()}, init.adam.count),
        alive=moved(init.alive), **{k: moved(getattr(init, k)) for k in gf.STAT_FIELDS}))
    for t in trainers:
        t.system.step_draws = lambda step: {"arap_t": 0.37}
    native.reset_launches()
    trainers[1].fit()
    launches = dict(native.LAUNCHES)
    trainers[0].fit()
    assert all(launches[k] > 0 for k in RASTER_KERNELS), launches
    assert launches["flash_attention_forward"] == 0
    rows = [t.metrics_log for t in trainers]
    assert len(rows[0]) == len(rows[1]) == 2
    for row_p, row_c in zip(*rows):
        assert "train/loss_lite_arap_reg" in row_c and "train/loss_ref_gs" in row_c
        for k in (k for k in row_p if k.startswith("train/")):
            assert np.isfinite(row_c[k])
            assert row_c[k] == pytest.approx(row_p[k], rel=1e-3, abs=1e-6), k
    lrs = trainers[0].system.geometry.lr_tree(0)
    alive = trainers[0].state.gauss.alive
    for k, want in trainers[0].state.gauss.params.as_dict().items():
        if want.numel() == 0:  # features_rest at sh_degree 0
            continue
        got = getattr(trainers[1].state.gauss.params, k).cpu()
        diff = (got - want).abs().reshape(want.shape[0], -1)[alive].amax(-1)
        assert float((diff <= 0.02 * lrs[k]).float().mean()) >= 0.99, k


def test_sugar_step_on_card_matches_cpu(cuda, tmp_path):
    """Two steps of sugar_static_refine.yaml's stage "sugar" bound to a
    320-face icosphere (6 Gaussians a face, the SuGaR renderer at 7
    channels) on the card and on the CPU, at 64^2: the losses to 1e-3
    relative, 99% of each param's rows within 2% of its learning rate (the
    in-plane rotation through the covariance it gives: its two tangent
    scales start equal), K1/K2 launched at 7 channels only."""
    from threestudio_3dgs_tpu_torch.models.sugar import SuGaRParams, SuGaRState
    from threestudio_3dgs_tpu_torch.models.optim import AdamState
    from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
    from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
    from threestudio_3dgs_tpu_torch.systems.base import SystemState
    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    overrides = [
        "trainer.max_steps=2", "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
        "data.image_path=", "data.height=64", "data.width=64", "data.random_camera.height=64",
        "data.random_camera.width=64", "data.random_camera.batch_size=1",
        "system.renderer.tile_size=16", "system.guidance.min_step_percent=0.5",
        "system.guidance.max_step_percent=0.5",
    ]
    config = os.path.join(CONFIG_DIR, "sugar_static_refine.yaml")
    trainers = [Trainer(load_config(config, overrides + [f"exp_root_dir={tmp_path / d.type}"]),
                        device=d) for d in (torch.device("cpu"), cuda)]
    verts, faces = icosphere()
    for t in trainers:
        t.system.bind_mesh(verts, faces)
    init = trainers[0].system.init_state(0).gauss

    def moved(t):
        return t.to(cuda).clone()

    trainers[0].state = SystemState(gauss=init)
    trainers[1].state = SystemState(gauss=SuGaRState(
        params=SuGaRParams(**{k: moved(v) for k, v in init.params.as_dict().items()}),
        adam=AdamState({k: moved(v) for k, v in init.adam.mu.items()},
                       {k: moved(v) for k, v in init.adam.nu.items()}, init.adam.count),
        faces=moved(init.faces), bary=moved(init.bary), thickness=moved(init.thickness)))
    native.reset_launches()
    trainers[1].fit()
    by_c = dict(native.SHAPE_LAUNCHES)
    launches = dict(native.LAUNCHES)
    trainers[0].fit()
    assert all(launches[k] > 0 for k in RASTER_KERNELS), launches
    assert set(by_c) == {("blend_forward", "C7"), ("blend_backward", "C7")}, by_c
    rows = [t.metrics_log for t in trainers]
    assert len(rows[0]) == len(rows[1]) == 2
    for row_p, row_c in zip(*rows):
        assert "train/loss_normal_consistency" in row_c and row_c["n_faces"] == 320
        for k in (k for k in row_p if k.startswith("train/")):
            assert np.isfinite(row_c[k])
            assert row_c[k] == pytest.approx(row_p[k], rel=1e-3, abs=1e-6), k
    lrs = trainers[0].system.geometry.lr_tree(0)
    states = [t.state.gauss for t in trainers]
    for k in ("points", "sh_dc", "scales", "densities"):
        want = getattr(states[0].params, k)
        diff = (getattr(states[1].params, k).cpu() - want).abs().reshape(want.shape[0], -1)
        assert float((diff.amax(-1) <= 0.02 * lrs[k]).float().mean()) >= 0.99, k
    geo = trainers[0].system.geometry

    def covs(state):
        a = geo.as_gaussian_arrays(dataclasses.replace(
            state, params=SuGaRParams(**{k: v.cpu() for k, v in state.params.as_dict().items()}),
            faces=state.faces.cpu(), bary=state.bary.cpu(), thickness=state.thickness.cpu()))
        return covariance_from_scaling_rotation(a["scales"], a["quats"])

    want = covs(states[0])
    assert float((covs(states[1]) - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_sugar_zero123_yamls_on_card(cuda, tmp_path):
    """gs_to_sugar_zero123.yaml for 2 steps through the launcher on the
    card, then sugar_static_refine_zero123.yaml (normal-depth consistency
    on) bound to its checkpoint for 2 steps, at 64^2: finite losses, no
    dropped pairs, K1/K2 at 4 channels in the first and 7 in the second,
    the PLY of every bound Gaussian."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models.ply_io import read_ply_table

    small = ["trainer.max_steps=2", "trainer.val_check_interval=0", "data.image_path=",
             "data.height=64", "data.width=64", "data.random_camera.height=64",
             "data.random_camera.width=64", "data.random_camera.batch_size=2",
             "data.random_camera.eval_height=64", "data.random_camera.eval_width=64",
             "data.random_camera.n_test_views=1", "system.renderer.max_pairs=16777216"]
    runs = {}
    for name, channels in (("gs_to_sugar_zero123", 4), ("sugar_static_refine_zero123", 7)):
        extra = []
        if channels == 7:
            extra = [f"system.geometry_convert_from={runs['gs_to_sugar_zero123']}"]
        native.reset_launches()
        t = launch.main(["--config", os.path.join(CONFIG_DIR, f"{name}.yaml"), "--train",
                         f"exp_root_dir={tmp_path / name}"] + small + extra)
        torch.cuda.synchronize()
        assert set(native.SHAPE_LAUNCHES) == {("blend_forward", f"C{channels}"),
                                              ("blend_backward", f"C{channels}")}
        assert len(t.metrics_log) == 2
        for row in t.metrics_log:
            assert row["n_dropped_pairs"] == 0
            assert all(np.isfinite(v) for k, v in row.items() if k.startswith("train/"))
        runs[name] = os.path.join(t.save_dir, "ckpts", "last.ckpt.npz")
    assert "train/loss_normal_depth_consistency" in t.metrics_log[-1]
    ply = read_ply_table(os.path.join(t.save_dir, "save", "point_cloud.ply"))
    assert len(ply["x"]) == t.state.gauss.n_gaussians > 0


# ---------------------------------------------------------------------------
# dynamic SuGaR: the four YAMLs, K5 at the temporal guidance's CFG batches,
# K1/K2 at C = 7 on a timed view
# ---------------------------------------------------------------------------


def write_icosphere_obj(path, subdivisions):
    from threestudio_3dgs_tpu_torch.models.mesh_extract import save_obj
    from threestudio_3dgs_tpu_torch.ops.mesh import icosphere

    verts, faces = icosphere(subdivisions)
    save_obj(str(path), verts, faces)
    return len(faces)


@pytest.mark.parametrize("yaml", ["sugar_dynamic", "sugar_dynamic_dg", "sugar_dynamic_dg_zero123",
                                  "sugar_drag"])
def test_sugar_dynamic_yamls_on_card(cuda, tmp_path, yaml):
    """Each dynamic SuGaR YAML at its own widths, bound to a 5,120-face
    icosphere, 2 steps through the launcher on the card on the temporal
    Zero123 guidance's analytic prior: finite losses, no dropped pairs,
    K1/K2 at 7 channels only, the node tracks (discrete) or the
    deformation network (deformation) trained, the PLY of every bound
    Gaussian."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models.ply_io import read_ply_table

    n_faces = write_icosphere_obj(tmp_path / "mesh.obj", 4)
    native.reset_launches()
    t = launch.main(["--config", os.path.join(CONFIG_DIR, f"{yaml}.yaml"), "--train",
                     "trainer.max_steps=2", "trainer.val_check_interval=0",
                     "data.random_camera.n_test_views=1",
                     f"system.geometry.surface_mesh_to_bind_path={tmp_path / 'mesh.obj'}",
                     f"exp_root_dir={tmp_path / 'run'}"])
    torch.cuda.synchronize()
    assert set(native.SHAPE_LAUNCHES) == {("blend_forward", "C7"), ("blend_backward", "C7")}
    assert all(native.LAUNCHES[k] > 0 for k in RASTER_KERNELS)
    assert len(t.metrics_log) == 2 and t.state.gauss.n_faces == n_faces
    for row in t.metrics_log:
        assert row["n_dropped_pairs"] == 0
        assert all(np.isfinite(v) for k, v in row.items() if k.startswith("train/"))
        assert "train/loss_arap_reg" in row
    init = t.system.init_state(t.cfg.seed)
    params, init_params = t.state.gauss.params, init.gauss.params
    if t.system.geometry.cfg.dynamic_mode == "discrete":
        assert float((params.node_trans - init_params.node_trans).abs().max()) > 0
    else:
        deform = t.state.extra_params["deformation"]
        assert any(not torch.equal(v, init.extra_params["deformation"][k])
                   for k, v in deform.items())
    ply = read_ply_table(os.path.join(t.save_dir, "save", "point_cloud.ply"))
    assert len(ply["x"]) == t.state.gauss.n_gaussians


@pytest.mark.parametrize("bh,rising", [(256, False), (256, True), (16, False), (16, True)],
                         ids=["cfg32", "cfg32_rising", "cfg2", "cfg2_rising"])
@torch.no_grad()
def test_flash_attention_sugar_dynamic_shapes(cuda, bh, rising):
    """K5 in bf16 at the temporal Zero123's level-0 self-attention on the
    dynamic SuGaR YAMLs: (256, 1024, 40) (CFG batch 2 x 16 views, 8 heads)
    and (16, 1024, 40) (sugar_drag: 2 x 1 view), on standard normal and on
    rising keys, to 2^-6 of max|plain| (k5_tolerance)."""
    q, k, v = k5_inputs(bh, 1024, torch.bfloat16, seed=3, rising=rising, d=40)
    got = fa.flash_bhnd_cuda(q, k, v, 40**-0.5)
    want = fa.flash_bhnd_torch(q, k, v, 40**-0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= k5_tolerance(want)


@torch.no_grad()
def test_blend_kernels_on_timed_sugar_view(cuda, tmp_path):
    """K1/K2 at C = 7 (rgb, depth, face normals) on a 256^2 view of a dynamic
    SuGaR field at t = 0.3 (a 5,120-face icosphere, 6 Gaussians a face,
    DQS over random node tracks, tile 32 as the YAMLs render), against
    their plain versions with bitwise reruns."""
    from threestudio_3dgs_tpu_torch.models.dynamic_sugar import DynamicSuGaRModel
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    write_icosphere_obj(tmp_path / "mesh.obj", 4)
    geo = DynamicSuGaRModel(dict(surface_mesh_to_bind_path=str(tmp_path / "mesh.obj"),
                                 n_gaussians_per_surface_triangle=6, skinning_method="dqs",
                                 n_dg_nodes=64, num_frames=6), device=cuda)
    state = geo.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(4)
    p = state.params
    p.node_trans = torch.randn(p.node_trans.shape, generator=gen, device=cuda) * 0.05
    p.node_rots = p.node_rots + torch.randn(p.node_rots.shape, generator=gen, device=cuda) * 0.2
    a = geo.get_timed_gs_arrays(state, 0.3, 1)
    cam = pcam.camera_from_c2w(lookat_c2w([0.0, -2.0, 0.4]), 0.86, 0.86, 256, 256, device=cuda)
    colors = sh_colors(a["means3d"], a["sh_coeffs"], cam.campos, geo.active_sh_degree)
    inp = view_inputs(dict(means=a["means3d"], scales=a["scales"], quats=a["quats"],
                           opac=a["opacities"], colors=colors, extra=a["normals"], cam=cam,
                           alive=None, tile_size=32), seed=5)
    assert inp["dims"][3] == 7 and inp["bins"].n_pairs > 0
    native.reset_launches()
    check_blend_kernels(inp["pair_feats"], inp["bins"].tile_ranges, inp["g_out"], inp["dims"])
    assert native.SHAPE_LAUNCHES == {("blend_forward", "C7"): 2, ("blend_backward", "C7"): 2}


def band_renders(scene, device, ts, n_bands):
    """The scene's full render and its n_bands tile-row bands
    (``rasterize(tile_band=...)``), each with the gradients of
    sum(image^2) + 0.2 sum(alpha) (the bands' summed)."""
    leaves = [scene[k].detach().to(device).requires_grad_(True)
              for k in ("means", "scales", "quats", "opac", "colors")]
    size = scene["cam"].height
    cam = pcam.camera_from_c2w(lookat_c2w([0.0, -2.5, 0.3]), 0.9, 0.9, size, size,
                               device=device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    cfg = RasterizeConfig(tile_size=ts)
    rows = size // ts // n_bands
    results = []
    for bands in ([None], [(b * rows, rows) for b in range(n_bands)]):
        outs = [rasterize(*leaves[:4], cam, bg, colors=leaves[4], config=cfg, tile_band=band)
                for band in bands]
        loss = sum(torch.sum(o["image"] ** 2) + 0.2 * torch.sum(o["alpha"]) for o in outs)
        out = {k: torch.cat([o[k] for o in outs]).detach() for k in ("image", "alpha", "depth")}
        out["radii"] = outs[0]["radii"]
        out["visibility"] = torch.stack([o["visibility"] for o in outs]).any(dim=0)
        out["n_dropped"] = sum(o["n_dropped"] for o in outs)
        results.append((out, torch.autograd.grad(loss, leaves)))
    return results


def test_band_render_on_card(cuda):
    """4 tile-row bands of a 128^2 view on the card: stitched, they equal
    the full render (image / alpha 1e-5, depth 1e-4, radii and visibility
    exactly; the bands' summed gradients to 1e-3 relative), every band
    launched K1-K4, and the bands equal the same bands on the CPU."""
    scene = make_scene(cuda, n=2000, size=128, seed=5)
    native.reset_launches()
    (full, g_full), (band, g_band) = band_renders(scene, cuda, 16, 4)
    launches = dict(native.LAUNCHES)
    assert all(launches[k] == 5 for k in RASTER_KERNELS), launches  # 1 full + 4 bands
    assert full["n_dropped"] == band["n_dropped"] == 0
    for name, tol in (("image", 1e-5), ("alpha", 1e-5), ("depth", 1e-4)):
        assert float((band[name] - full[name]).abs().max()) <= tol, name
    assert torch.equal(band["radii"], full["radii"])
    assert torch.equal(band["visibility"], full["visibility"])
    for gb, gf in zip(g_band, g_full):
        assert float(torch.linalg.norm(gb - gf)) <= 1e-3 * float(torch.linalg.norm(gf))
    (_, _), (band_cpu, g_cpu) = band_renders(scene, torch.device("cpu"), 16, 4)
    for name in ("image", "alpha", "depth"):
        assert float((band[name].cpu() - band_cpu[name]).abs().max()) <= 6e-4, name
    for gb, gc in zip(g_band, g_cpu):
        assert float((gb.cpu() - gc).abs().max()) <= 1e-3 * float(gc.abs().max())


def test_dp_step_world1_nccl_matches_plain(cuda, tmp_path):
    """trainer.devices=1 on the card: the data-parallel step on a one-rank
    NCCL group (sum over one rank, divided by 1) gives the one-process
    step's state bit for bit after 4 steps at 4 views (the single pass from
    step 1), its group destroyed after."""
    import torch.distributed as dist

    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    states = {}
    for devices in (0, 1):
        cfg = load_config(PORT_CONFIG, [
            "trainer.max_steps=4", "trainer.val_check_interval=0", "data.width=128",
            "data.height=128", "data.batch_size=4", "system.geometry.init_num_pts=1024",
            "system.geometry.capacity=4096", "system.guidance_type=fake-sds-guidance",
            f"trainer.devices={devices}", f"exp_root_dir={tmp_path / str(devices)}"])
        tr = Trainer(cfg, device="cuda")
        try:
            assert (tr.mesh is None) == (devices == 0)
            if devices:
                assert dist.get_backend() == "nccl"
            tr.fit()
            states[devices] = tr.state.gauss
            steps = sorted(tr.system._dp_steps)
        finally:
            tr.close()
    assert steps == [("dp", 1, 4)] and not dist.is_initialized()
    for k, v in states[0].params.as_dict().items():
        assert torch.equal(getattr(states[1].params, k), v), k
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert torch.equal(getattr(states[1], k), getattr(states[0], k)), k
