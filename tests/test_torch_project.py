"""K7's plain twins (``ops/rasterizer/project.py``) on the CPU.

The forward twin against ``project_gaussians`` plus the binning's plain row
pass, view by view (integers and counts exactly, floats to 1e-6, the
culled rows at the kernel's culled outputs); the hand backward twin
against ``torch.autograd`` through ``project_gaussians`` in float64 (1e-6
of each gradient's largest entry on the rows in frustum with det > 0,
exact zeros elsewhere, finite everywhere); ``rasterize`` and
``rasterize_batched`` through ``Project`` against the plain path under
autograd; and the ``render/project`` spans.  Each case adds one kind of
row to an ordinary scene: dead rows, rows at view depth <= 0.2, rows at
and past both Jacobian clamps, rows with det <= 0, rects above
``MASK_K`` tiles, three stacked views, a scaling modifier and a means2d
offset.  The kernels themselves are held to these twins on the card in
``tests/test_torch_gpu.py``.
"""

import math

import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)
from threestudio_3dgs_tpu_torch.ops import camera as pcam
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, api, rasterize
from threestudio_3dgs_tpu_torch.ops.rasterizer import rasterize_batched
from threestudio_3dgs_tpu_torch.ops.rasterizer.binning import row_fields
from threestudio_3dgs_tpu_torch.ops.rasterizer.expand import MASK_K, MASK_NONE
from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import (
    camera_scalars, project_gaussians)
from threestudio_3dgs_tpu_torch.ops.rasterizer.project import (
    ProjectViews, _to_input, conic_terms, project_bwd_torch, project_fwd_torch, project_plain)
from threestudio_3dgs_tpu_torch.utils.profiling import lookat_c2w

CASES = ("dead", "near", "clamp", "det", "big_rects", "batched", "modifier", "offset")
TILE = 16


def axis_camera(size=128, fov=0.9):
    """A camera at the origin looking down +z (w2c the identity): view
    depth is the mean's z and view x / z its x / z, exactly."""
    tan = math.tan(fov / 2)
    w2c = torch.eye(4)
    proj = pcam.projection_matrix(0.1, 100.0, torch.tensor(tan), torch.tensor(tan))
    return pcam.Camera(w2c=w2c, full_proj=proj @ w2c, campos=torch.zeros(3), tanfovx=tan,
                       tanfovy=tan, height=size, width=size)


def ring_cameras(b, size=128):
    return [pcam.camera_from_c2w(
        lookat_c2w([2.5 * math.sin(2 * math.pi * v / b), -2.5 * math.cos(2 * math.pi * v / b),
                    0.3 + 0.2 * v]), 0.9, 0.8, size, size, device="cpu") for v in range(b)]


def make_case(case, dtype=torch.float32, n=600, seed=0):
    """(inputs, cameras, scaling modifier, rows to leave out of the
    backward comparison) of one case; inputs by ``project``'s names."""
    rng = np.random.default_rng(seed)
    on_axis = case in ("near", "clamp")
    means = rng.normal(size=(n, 3)) * 0.35 + (np.array([0.0, 0.0, 2.2]) if on_axis else 0.0)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.5 - 3.2)
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.05, 0.95, size=n)
    alive = None
    offset = None
    modifier = 1.0
    cams = [axis_camera()] if on_axis else ring_cameras(1)
    skip = np.zeros(n, bool)
    k = n // 4
    if case == "dead":
        alive = rng.uniform(size=n) < 0.5
    elif case == "near":
        means[:k, 2] = rng.uniform(-1.0, 0.2, size=k)
        means[k, 2] = 0.2  # the cull's bound: culled
        means[k + 1, 2] = np.nextafter(np.float32(0.2), np.float32(1.0))
    elif case == "clamp":
        _, _, lx, ly = camera_scalars(cams[0])
        z = 2.0
        exact = [(2 * lx, 0.0), (-2 * lx, 0.0), (0.0, 2 * ly), (0.0, -2 * ly)]
        means[:4] = [(x, y, z) for x, y in exact]  # view x / z on the limits exactly
        beyond = rng.uniform(1.05, 2.0, size=(k, 2)) * rng.choice([-1.0, 1.0], size=(k, 2))
        means[4:4 + k, :2] = beyond * np.array([lx, ly]) * means[4:4 + k, 2:3]
    elif case == "det":
        # near-rank-1 covariances this large lose det to rounding
        big = 1e4 if dtype == torch.float32 else 1e9
        scales[:k] = np.stack([np.full(k, big), np.full(k, 1e-3), np.full(k, 1e-3)], 1)
        skip[:k] = True
    elif case == "big_rects":
        scales[:k] = np.exp(rng.normal(size=(k, 3)) * 0.2 - 1.5)
    elif case == "batched":
        cams = ring_cameras(3)
        means = np.stack([means + rng.normal(size=(n, 3)) * 0.01 for _ in range(3)])
        alive = rng.uniform(size=(3, n)) < 0.9
        offset = rng.normal(size=(3, n, 2)) * 0.01
    elif case == "modifier":
        modifier = 0.7
    elif case == "offset":
        offset = rng.normal(size=(n, 2)) * 0.01
    as_t = lambda a: None if a is None else torch.tensor(a, dtype=dtype)  # noqa: E731
    inputs = dict(means3d=as_t(means), scales=as_t(scales), quats=as_t(quats),
                  opacities=as_t(opac), alive=None if alive is None else torch.tensor(alive),
                  means2d_offset=as_t(offset))
    return inputs, cams, modifier, torch.tensor(skip)


def view_of(t, v, base_ndim):
    """View v of an input with a leading view axis, else the input."""
    return t if t is None or t.dim() == base_ndim else t[v]


def live_rows(proj, alive):
    live = proj.depths > 0.2
    return live if alive is None else live & alive


@pytest.mark.parametrize("case", CASES)
def test_fwd_twin_matches_plain(case):
    inputs, cams, modifier, _ = make_case(case)
    views = ProjectViews(tuple(cams), TILE, modifier)
    with torch.no_grad():
        proj, rows = project_fwd_torch(
            inputs["means3d"], inputs["scales"], inputs["quats"], inputs["opacities"],
            inputs["alive"], inputs["means2d_offset"], views)
    n = inputs["scales"].shape[-2]
    gy = (cams[0].height + TILE - 1) // TILE
    seen = dict(culled=0, clamped=0, det=0, big=0)
    for v, cam in enumerate(cams):
        # the reference: project_gaussians and the row pass, rects shifted
        # to the view's tile rows as rasterize_batched stacks them
        with torch.no_grad():
            p = project_gaussians(
                view_of(inputs["means3d"], v, 2), view_of(inputs["scales"], v, 2),
                view_of(inputs["quats"], v, 2), cam, TILE, modifier,
                alive=view_of(inputs["alive"], v, 1),
                means2d_offset=view_of(inputs["means2d_offset"], v, 2))
            shift = torch.tensor([0, v * gy], dtype=torch.int32)
            p = p._replace(tiles_min=p.tiles_min + shift, tiles_max=p.tiles_max + shift)
            r = row_fields(p, TILE, view_of(inputs["opacities"], v, 1), gy if len(cams) > 1 else 0)
        sl = slice(v * n, (v + 1) * n)
        live = live_rows(p, view_of(inputs["alive"], v, 1))
        col = live[:, None]
        # integers, counts and the sort key: exactly, on every row
        assert torch.equal(proj.depths[sl], p.depths)
        assert torch.equal(proj.radii[sl], p.radii)
        assert torch.equal(proj.visible[sl], p.visible)
        assert torch.equal(rows.counts[sl], r.counts)
        assert torch.equal(rows.sort_key[sl], r.sort_key)
        assert torch.equal(rows.rect[sl][:, 3], r.rect[:, 3])
        for got, want in ((proj.tiles_min[sl], p.tiles_min), (proj.tiles_max[sl], p.tiles_max),
                          (rows.rect[sl][:, :3], r.rect[:, :3])):
            assert torch.equal(got[live], want[live])
            assert not got[~live].any()
        # floats: to 1e-6 on live rows, zeros on culled rows
        for got, want in ((proj.means2d[sl], p.means2d), (proj.conics[sl], p.conics),
                          (rows.cull_fields[sl], r.cull_fields)):
            scale = want[live].abs().amax(0).clamp_min(1.0)
            assert ((got[live] - want[live]).abs() <= 1e-6 * scale).all()
            assert torch.equal(got[~live], torch.zeros_like(got[~live]))
        culled = ~live
        assert (rows.rect[sl][culled][:, 3] == MASK_NONE).all()
        assert torch.isinf(rows.sort_key[sl][culled]).all()
        assert not rows.counts[sl][culled].any() and not proj.radii[sl][culled].any()
        seen["culled"] += int(culled.sum())
        _, _, lx, ly = camera_scalars(cams[v])
        m = view_of(inputs["means3d"], v, 2)
        if case == "clamp":
            u = (m[:, 0] / m[:, 2]).abs()
            seen["clamped"] += int((live & (u >= lx)).sum())
        ca, cb, cc = p.conics.unbind(-1)
        seen["det"] += int((live & (ca * cc - cb * cb <= 0)).sum())
        area = (r.rect[:, 2].long() * (p.tiles_max[:, 1] - p.tiles_min[:, 1]).long())
        seen["big"] += int((p.visible & (area > MASK_K)).sum())
    # each case holds the rows it is named after
    want = {"dead": "culled", "near": "culled", "clamp": "clamped", "det": "det",
            "big_rects": "big"}.get(case)
    if want:
        assert seen[want] > 0, seen
    if case == "batched":
        assert rows.rect[:, 1].max() >= 2 * ((cams[0].height + TILE - 1) // TILE)


@pytest.mark.parametrize("case", CASES)
def test_bwd_twin_matches_autograd(case):
    inputs, cams, modifier, skip = make_case(case, dtype=torch.float64)
    views = ProjectViews(tuple(cams), TILE, modifier)
    n = inputs["scales"].shape[-2]
    b = len(cams)
    gen = torch.Generator().manual_seed(1)
    g_m2, g_d, g_c = (torch.randn(shape, generator=gen, dtype=torch.float64)
                      for shape in ((b * n, 2), (b * n,), (b * n, 3)))
    offset = inputs["means2d_offset"]
    if offset is None:
        offset = torch.zeros((b, n, 2) if b > 1 else (n, 2), dtype=torch.float64)
    names = ("means3d", "scales", "quats")
    leaves = {k: inputs[k].clone().requires_grad_(True) for k in names}
    leaves["offset"] = offset.clone().requires_grad_(True)
    twin = project_bwd_torch(leaves["means3d"].detach(), leaves["scales"].detach(),
                             leaves["quats"].detach(), inputs["alive"], views, g_m2, g_d, g_c,
                             True)
    seen_zero = 0
    for v, cam in enumerate(cams):
        sl = slice(v * n, (v + 1) * n)
        alive_v = view_of(inputs["alive"], v, 1)
        p = project_gaussians(
            view_of(leaves["means3d"], v, 2), view_of(leaves["scales"], v, 2),
            view_of(leaves["quats"], v, 2), cam, TILE, modifier, alive=alive_v,
            means2d_offset=view_of(leaves["offset"], v, 2))
        loss = (p.means2d * g_m2[sl]).sum() + (p.depths * g_d[sl]).sum() \
            + (p.conics * g_c[sl]).sum()
        want = torch.autograd.grad(loss, [leaves[k] for k in (*names, "offset")])
        # in frustum with det > 0, as project_gaussians decides it
        live = conic_terms(*(view_of(inputs[k], v, 2) for k in names), cam, modifier,
                           alive_v)["live"]
        assert torch.equal(live & ~skip, live_rows(p, alive_v) & ~skip)
        cmp_rows = live & ~skip
        for got, w, like in zip(twin, want, (*(inputs[k] for k in names), offset)):
            # this view's share: a per-view input's row v, a shared input's all
            got_v, w_v = got[v], (w[v] if like.dim() == got.dim() else w)
            assert torch.isfinite(got_v).all()
            scale = w_v[cmp_rows].abs().max()
            assert (got_v[cmp_rows] - w_v[cmp_rows]).abs().max() <= 1e-6 * scale
            assert not got_v[~live].any()
            seen_zero += int((~live).sum())
    if case in ("dead", "near", "det"):
        assert seen_zero > 0
    if case == "det":  # det <= 0 among the rows in frustum
        assert (live_rows(p, None) & ~live).any()
    if b > 1:  # inputs the views share get the views' sum
        for got, like in zip(twin, (*(inputs[k] for k in names), offset)):
            summed = _to_input(got, like)
            assert summed.shape == like.shape and torch.isfinite(summed).all()


@pytest.mark.parametrize("batched", [False, True], ids=["one_view", "batched"])
def test_rasterize_through_project_matches_plain(batched, monkeypatch):
    inputs, cams, modifier, _ = make_case("batched" if batched else "offset", n=1500)
    colors = torch.rand((inputs["scales"].shape[-2], 3), generator=torch.Generator().manual_seed(2))

    def render():
        leaves = [inputs[k].clone().requires_grad_(True)
                  for k in ("means3d", "scales", "quats", "opacities", "means2d_offset")]
        col = colors.clone().requires_grad_(True)
        kw = dict(colors=col, alive=inputs["alive"], means2d_offset=leaves[4],
                  scaling_modifier=modifier, config=RasterizeConfig(tile_size=TILE))
        if batched:
            out = rasterize_batched(*leaves[:4], cams, torch.zeros(3), **kw)
        else:
            out = rasterize(*leaves[:4], cams[0], torch.zeros(3), **kw)
        loss = (out["image"] ** 2).sum() + out["alpha"].sum() + 0.1 * out["depth"].sum()
        return out, torch.autograd.grad(loss, leaves + [col])

    got, got_g = render()
    if batched:  # the per-view loop of the plain path
        outs = []
        for v, cam in enumerate(cams):
            monkeypatch.setattr(api, "project", project_plain)
            kw = dict(colors=colors, alive=inputs["alive"][v],
                      means2d_offset=inputs["means2d_offset"][v], scaling_modifier=modifier,
                      config=RasterizeConfig(tile_size=TILE))
            outs.append(rasterize(inputs["means3d"][v], inputs["scales"], inputs["quats"],
                                  inputs["opacities"], cam, torch.zeros(3), **kw))
            monkeypatch.undo()
        for k in ("image", "alpha", "depth", "radii", "visibility"):
            assert torch.equal(got[k], torch.stack([o[k] for o in outs])), k
        assert got["n_pairs"] == sum(o["n_pairs"] for o in outs)
        return
    monkeypatch.setattr(api, "project", project_plain)
    want, want_g = render()
    for k in ("image", "alpha", "depth", "radii", "visibility", "n_pairs"):
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k
    for g, w in zip(got_g, want_g):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-5 * w.abs().max()), (g - w).abs().max()


def test_project_spans_a_render():
    inputs, cams, modifier, _ = make_case("offset")
    means = inputs["means3d"].clone().requires_grad_(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # no depth channel: the backward gets no gradient of the depths
        out = rasterize(means, inputs["scales"], inputs["quats"], inputs["opacities"], cams[0],
                        torch.zeros(3), colors=torch.ones_like(means), with_depth=False,
                        config=RasterizeConfig(tile_size=TILE))
        out["image"].sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count("render/project") == 2  # the forward and, in render/backward, its backward
    assert torch.isfinite(means.grad).all() and means.grad.abs().sum() > 0


def test_offset_without_gradient():
    """A means2d offset that needs no gradient gets none; the means do."""
    inputs, cams, modifier, _ = make_case("offset")
    means = inputs["means3d"].clone().requires_grad_(True)
    out = rasterize(means, inputs["scales"], inputs["quats"], inputs["opacities"], cams[0],
                    torch.zeros(3), colors=torch.ones_like(means),
                    means2d_offset=inputs["means2d_offset"], config=RasterizeConfig(tile_size=TILE))
    out["image"].sum().backward()
    assert torch.isfinite(means.grad).all() and means.grad.abs().sum() > 0


def test_isotropic_rotation_gradient_is_zero():
    """At the identity rotation every field starts from, an isotropic
    Gaussian's quaternion gets exactly zero gradient from the hand backward,
    as from autograd through ``project_gaussians``."""
    inputs, cams, modifier, _ = make_case("offset")
    scales = inputs["scales"][:, :1].repeat(1, 3)
    quats = torch.zeros_like(inputs["quats"])
    quats[:, 0] = 1.0
    leaf = quats.clone().requires_grad_(True)
    p = project_gaussians(inputs["means3d"], scales, leaf, cams[0], TILE)
    gen = torch.Generator().manual_seed(4)
    g_m2, g_d, g_c = (torch.randn(t.shape, generator=gen) for t in (p.means2d, p.depths, p.conics))
    loss = (p.means2d * g_m2).sum() + (p.depths * g_d).sum() + (p.conics * g_c).sum()
    want, = torch.autograd.grad(loss, [leaf])
    views = ProjectViews(tuple(cams), TILE, modifier)
    got = project_bwd_torch(inputs["means3d"], scales, quats, None, views, g_m2, g_d, g_c, False)
    assert not want.any() and not got[2].any()
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0
