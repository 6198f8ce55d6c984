"""The port's single-pass batched render and its adaptive pair-capacity
controller against the JAX package on the CPU.

Covered: ``rasterize_batched`` (static and per-view attributes, SH degree
0 and 3, extra features, a means2d offset, per-view backgrounds, one view,
a capacity cut) against the JAX package's and against the port's own
per-view ``rasterize``; the plain K1/K2 twins on a grid of stacked views
(``view_grid_y``) against ``blend_jax`` and the Pallas kernels in
interpret mode; the plain K4 twin's pair lists against the JAX binning of
the same stacked scene; every Gaussian renderer variant, the spacetime
renderer and both SuGaR renderer kinds (static, temporal) with
``batched=true`` in both packages; the renderers' gate; the controller fed
one (demand, dropped) trace; a short gaussian_splatting.yaml run with its
own ``batched`` and ``adaptive_max_pairs`` in both packages; and the
blend's gradients against autograd through ``ops/rasterizer/dense.py``.

Tolerances: forward outputs to 1e-5 absolute against the JAX package (its
blend twin walks the same pairs in chunks) and bit for bit against the
port's own loop; gradients to 2e-4 x max(1, max|JAX gradient|) per input,
the bound of the JAX package's own batched-vs-loop test
(tests/test_rasterize_batched.py)."""

import contextlib
import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)
from test_torch_train import JAX_ONLY, OVERRIDES, PARAM_ATOL, ROOT
from test_torch_rasterizer import T, port_camera
from test_torch_renderers import VARIANTS, check_outputs_and_grads, make_pair, render_both
from test_torch_spacetime import random_spacetime_params
from test_torch_sugar import bumpy_sphere
from test_torch_sugar_dynamic import N_KNOTS, N_NODES, jittered_sphere

from threestudio_3dgs_tpu.models import spacetime as jst
from threestudio_3dgs_tpu.ops import camera as jcam
from threestudio_3dgs_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from threestudio_3dgs_tpu.ops.rasterizer import blend_jax
from threestudio_3dgs_tpu.ops.rasterizer import rasterize_batched as jax_rasterize_batched
from threestudio_3dgs_tpu.ops.rasterizer.binning import bin_gaussians_with_feats
from threestudio_3dgs_tpu.ops.rasterizer.blend_pallas import (
    blend_backward_pallas, blend_forward_pallas)
from threestudio_3dgs_tpu.ops.rasterizer.dense import dense_render as jax_dense_render
from threestudio_3dgs_tpu.ops.rasterizer.preprocess import project_gaussians as jax_project
from threestudio_3dgs_tpu.systems import base as jbase
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.models import dynamic_sugar as pds
from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models import spacetime as pst
from threestudio_3dgs_tpu_torch.models import sugar as psugar
from threestudio_3dgs_tpu_torch.models.convert import (
    dynamic_sugar_state_from_numpy, gaussian_state_from_numpy, sugar_state_from_numpy)
from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from threestudio_3dgs_tpu_torch.ops.rasterizer import rasterize_batched
from threestudio_3dgs_tpu_torch.ops.rasterizer import blend
from threestudio_3dgs_tpu_torch.ops.rasterizer.binning import bin_gaussians
from threestudio_3dgs_tpu_torch.ops.rasterizer.dense import dense_render
from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import Projected, project_gaussians
from threestudio_3dgs_tpu_torch.systems import base as pbase
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

FWD_ATOL = 1e-5
GRAD_SCALE = 2e-4


def cameras(b, height, width, seed=0):
    """b cameras around the origin: the JAX package's and the port's with
    the same f32 matrices."""
    out = []
    for v in range(b):
        ang = 0.7 * v + 0.3 + seed
        eye = np.array([2.2 * np.sin(ang), -2.2 * np.cos(ang), 0.4 + 0.2 * v])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
        out.append(jcam.camera_from_c2w(jnp.asarray(c2w), 0.8, 0.8, height, width))
    return out, [port_camera(c) for c in out]


def f32(a):
    return np.asarray(a, np.float32)


def scene_inputs(case):
    """The case's rasterize_batched inputs as numpy: (arrays, bg, kw, b,
    height, width, max_pairs).  static_sh0: three views of one field, SH
    degree 0; per_view_sh3: two views, each with its own means, scales,
    rotations, opacities and degree-3 SH (a timed field's form), static
    extra features, a means2d offset and a background a view; b1: one
    view; drop: two views past a 512-pair capacity."""
    b, n = {"static_sh0": (3, 300), "b1": (1, 300)}.get(case, (2, 300))
    height, width = 32, 48
    rng = np.random.default_rng(len(case))
    lead = (b,) if case == "per_view_sh3" else ()
    arrays = {
        "means3d": f32(rng.normal(size=lead + (n, 3)) * 0.4),
        "scales": f32(np.exp(rng.normal(size=lead + (n, 3)) * 0.4 - 2.6)),
        "quats": f32(rng.normal(size=lead + (n, 4))),
        "opacities": f32(rng.uniform(0.2, 0.95, size=lead + (n,))),
    }
    kw = {"sh_degree": 0}
    bg = f32([0.1, 0.2, 0.3])
    if case == "static_sh0":
        arrays["sh_coeffs"] = f32(rng.normal(size=(n, 1, 3)) * 0.5)
    elif case == "per_view_sh3":
        arrays["sh_coeffs"] = f32(rng.normal(size=lead + (n, 16, 3)) * 0.3)
        arrays["extra_features"] = f32(rng.normal(size=(n, 2)))
        arrays["means2d_offset"] = np.zeros((b, n, 2), np.float32)
        kw["sh_degree"] = 3
        bg = f32([[0.1, 0.2, 0.3], [0.9, 0.5, 0.0]])
    else:
        arrays["colors"] = f32(rng.uniform(size=(n, 3)))
    max_pairs = 512 if case == "drop" else 1 << 14
    return arrays, bg, kw, b, height, width, max_pairs


OUT_NAMES = ("image", "alpha", "depth", "extra")


def weights_for(out, seed):
    rng = np.random.default_rng(seed)
    return {k: f32(rng.normal(size=np.shape(out[k]))) for k in OUT_NAMES if k in out}


@pytest.mark.parametrize("case", ["static_sh0", "per_view_sh3", "b1", "drop"])
def test_rasterize_batched_matches_jax_and_loop(case):
    """Outputs and pair accounting against the JAX package's
    rasterize_batched (impl jax), and against the port's per-view
    rasterize: equal bit for bit where no pair drops, gradients of a
    weighted sum of every output to 2e-4 x scale; the capacity cut drops
    the same pairs in both packages."""
    arrays, bg, kw, b, height, width, max_pairs = scene_inputs(case)
    jcams, pcams = cameras(b, height, width)
    names = list(arrays)
    w = None

    def jfn(*xs):
        return jax_rasterize_batched(
            cameras=jcams, bg_color=jnp.asarray(bg),
            config=JaxRasterizeConfig(tile_size=16, max_pairs=max_pairs, impl="jax"),
            **dict(zip(names, xs)), **kw)

    def jloss(*xs):
        out = jfn(*xs)
        return sum(jnp.sum(out[k] * w[k]) for k in w), out

    w = weights_for(jax.eval_shape(jfn, *[jnp.asarray(a) for a in arrays.values()]), 0)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True))(
        *[jnp.asarray(a) for a in arrays.values()])

    xs = {k: T(a, grad=True) for k, a in arrays.items()}
    pout = rasterize_batched(cameras=pcams, bg_color=T(bg),
                             config=RasterizeConfig(tile_size=16, max_pairs=max_pairs),
                             **xs, **kw)
    assert sorted(pout) == sorted(jout)
    for k in OUT_NAMES:
        if k in jout:
            assert pout[k].shape == jout[k].shape, k
            np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                       atol=FWD_ATOL, err_msg=k)
    for k in ("radii", "visibility"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert (pout["n_pairs"], pout["n_dropped"]) == (int(jout["n_pairs"]), int(jout["n_dropped"]))
    assert (pout["n_dropped"] > 0) == (case == "drop")
    assert float(jout["alpha"].max()) > 0.5
    pgrads = torch.autograd.grad(sum(torch.sum(pout[k] * T(w[k])) for k in w), list(xs.values()))
    for name, got, want in zip(names, pgrads, jgrads):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_SCALE * scale,
                                   err_msg=name)
        assert np.abs(want).max() > 0, name
    if case == "drop":
        return

    # the port's own per-view loop: the same numbers
    xs_l = {k: T(a, grad=True) for k, a in arrays.items()}
    loop_loss = 0.0
    for v, cam in enumerate(pcams):
        view = {k: x[v] if k in lead_keys(case) else x for k, x in xs_l.items()}
        one = rasterize(camera=cam, bg_color=T(bg[v] if bg.ndim == 2 else bg),
                        config=RasterizeConfig(tile_size=16, max_pairs=max_pairs),
                        **view, **kw)
        for k in w:
            np.testing.assert_array_equal(pout[k][v].detach().numpy(),
                                          one[k].detach().numpy(), err_msg=f"view {v} {k}")
        np.testing.assert_array_equal(pout["radii"][v].numpy(), one["radii"].numpy())
        loop_loss = loop_loss + sum(torch.sum(one[k] * T(w[k][v])) for k in w)
    lgrads = torch.autograd.grad(loop_loss, list(xs_l.values()))
    for name, got, want in zip(names, pgrads, lgrads):
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_SCALE * scale, err_msg=name)


def lead_keys(case):
    """The inputs that carry a leading view axis."""
    if case == "per_view_sh3":
        return {"means3d", "scales", "quats", "opacities", "sh_coeffs", "means2d_offset"}
    return {"means2d_offset"}


# ---------------------------------------------------------------------------
# K1 / K2 / K4's plain twins on the stacked grid
# ---------------------------------------------------------------------------


def stacked_scene(b, height, width, ts, n, seed, big=0):
    """b views of one random scene projected by the JAX package and
    stacked as rasterize_batched stacks them: (proj, opacities, channels
    [rgb, depth], grid_x, grid_y of one view)."""
    rng = np.random.default_rng(seed)
    means = jnp.asarray(f32(rng.normal(size=(n, 3)) * 0.4))
    log_s = rng.normal(size=(n, 3)) * 0.4 - 2.6
    log_s[:big] += 1.6  # rects past MASK_K tiles: culled per pair in K4
    scales = jnp.asarray(f32(np.exp(log_s)))
    quats = jnp.asarray(f32(rng.normal(size=(n, 4))))
    opac = jnp.asarray(f32(rng.uniform(0.2, 0.95, size=(n,))))
    colors = jnp.asarray(f32(rng.uniform(size=(n, 3))))
    jcams, _ = cameras(b, height, width, seed=seed)
    gx, gy = (width + ts - 1) // ts, (height + ts - 1) // ts
    projs = []
    for v, cam in enumerate(jcams):
        p = jax_project(means, scales, quats, cam, ts)
        shift = jnp.asarray([0, v * gy], jnp.int32)
        projs.append(p._replace(tiles_min=p.tiles_min + shift, tiles_max=p.tiles_max + shift))
    proj = jax.tree_util.tree_map(lambda *x: jnp.concatenate(x, axis=0), *projs)
    chans = jnp.concatenate([jnp.tile(colors, (b, 1)), proj.depths[:, None]], axis=1)
    return proj, jnp.tile(opac, b), chans, gx, gy


def test_blend_twins_on_stacked_views_match_jax_and_pallas():
    """Two 32x16 views stacked on a (2, 2) grid of 16^2 tiles, binned by
    the JAX package with view_grid_y: the plain K1/K2 twins with
    view_grid_y against blend_jax (1e-6; backward per column to 1e-5 of
    its largest) and against blend_forward_pallas / blend_backward_pallas
    in interpret mode (1e-4 of the largest output or gradient, the JAX
    package's tolerance between them);
    without view_grid_y the second view's tiles come out different."""
    ts, c = 16, 4
    proj, opac, chans, gx, gy = stacked_scene(2, 16, 32, ts, 200, seed=3)
    bins, _ = bin_gaussians_with_feats(proj, gx, 2 * gy, 1 << 14, ts, opac, chans,
                                       view_grid_y=gy)
    feats = jnp.concatenate([proj.means2d, proj.conics, opac[:, None], chans], axis=1)
    n_valid = int(bins.tile_ranges[-1])
    pf = np.asarray(feats)[np.asarray(bins.pair_gauss)[:n_valid]]
    ranges = np.asarray(bins.tile_ranges)
    dims = (gx, 2 * gy, ts, c)
    g_out = f32(np.random.default_rng(4).normal(size=(2 * gx * gy, ts * ts, c + 1)))
    got = blend.blend_forward(T(pf), T(ranges, torch.int64), *dims, view_grid_y=gy).numpy()
    want = np.asarray(blend_jax.blend_forward(jnp.asarray(pf), jnp.asarray(ranges), *dims,
                                              view_grid_y=gy))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want[gx * gy:, :, -1].max() > 0.5  # the second view is drawn
    want_p = np.asarray(blend_forward_pallas(jnp.asarray(pf), jnp.asarray(ranges), *dims,
                                             interpret=True, view_grid_y=gy))
    np.testing.assert_allclose(got, want_p, rtol=0, atol=1e-4)
    single = blend.blend_forward(T(pf), T(ranges, torch.int64), *dims).numpy()
    assert np.abs(single[gx * gy:] - got[gx * gy:]).max() > 0.1

    got_g = blend.blend_backward(T(pf), T(ranges, torch.int64), T(want), T(g_out), *dims,
                                 view_grid_y=gy).numpy()
    want_g = np.asarray(blend_jax.blend_backward(
        jnp.asarray(pf), jnp.asarray(ranges), jnp.asarray(want), jnp.asarray(g_out), *dims,
        view_grid_y=gy))
    # per column, relative to the column's largest gradient (long f32 sums
    # rounded in another order by each framework), test_torch_kernels' bound
    scale = np.abs(want_g).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(np.abs(got_g - want_g).max(axis=0), 1e-5 * scale)
    want_gp = np.asarray(blend_backward_pallas(
        jnp.asarray(pf), jnp.asarray(ranges), jnp.asarray(want), jnp.asarray(g_out), *dims,
        interpret=True, view_grid_y=gy))
    # the JAX package's own bound between its Pallas kernel and its twin
    # (tests/test_blend_pallas.py): 1e-4 of the largest gradient
    np.testing.assert_allclose(got_g, want_gp, rtol=0, atol=1e-4 * np.abs(want_gp).max())


@pytest.mark.parametrize("max_pairs", [1 << 14, 2000])
def test_expand_twin_on_stacked_views_matches_jax(max_pairs):
    """Three 96^2 views of one scene (a tenth of its Gaussians with rects
    past MASK_K tiles, culled per pair) on an (18, 6) grid of 16^2 tiles:
    the port's binning with view_grid_y (the pre-cull mask and the plain
    K4 twin) against the JAX binning of the same projections, every tile
    range and tile-ordered pair list equal, also under a capacity cut
    (the globally deepest pairs dropped in both); without view_grid_y the
    cull tests the wrong tiles and the lists differ."""
    ts = 16
    proj, opac, _, gx, gy = stacked_scene(3, 96, 96, ts, 300, seed=5, big=30)
    want = jax.jit(lambda p, o: bin_gaussians_with_feats(
        p, gx, 3 * gy, max_pairs, ts, o, jnp.zeros((o.shape[0], 4)), view_grid_y=gy)[0])(
        proj, opac)
    pproj = Projected(*[T(np.asarray(x)) for x in proj])
    got = bin_gaussians(pproj, gx, 3 * gy, max_pairs, ts, T(np.asarray(opac)), view_grid_y=gy)
    assert (got.n_pairs, got.n_dropped) == (int(want.n_pairs), int(want.n_dropped))
    assert (got.n_dropped > 0) == (max_pairs < 1 << 14)
    np.testing.assert_array_equal(got.tile_ranges.numpy(), np.asarray(want.tile_ranges))
    n_valid = int(want.tile_ranges[-1])
    np.testing.assert_array_equal(got.pair_gauss[:n_valid].numpy(),
                                  np.asarray(want.pair_gauss)[:n_valid])
    rect = np.asarray(proj.tiles_max - proj.tiles_min)
    assert (rect[:, 0] * rect[:, 1] > 24).sum() > 0
    assert n_valid < got.n_pairs  # pairs of big rects culled in K4
    single = bin_gaussians(pproj, gx, 3 * gy, max_pairs, ts, T(np.asarray(opac)))
    assert not torch.equal(single.tile_ranges, got.tile_ranges)


# ---------------------------------------------------------------------------
# dense.py: the blend's gradients by autograd
# ---------------------------------------------------------------------------


def test_blend_gradients_match_dense_autograd():
    """rasterize (one view) and rasterize_batched (two views, view_grid_y)
    through the Blend function against autograd through the dense
    cumprod renderer of each view (gradients to 2e-4 of each input's
    largest, the JAX package's bound against its own dense renderer); the
    dense renderer's forward against the JAX package's to 1e-6."""
    arrays, _, _, b, height, width, _ = scene_inputs("dense")
    n = 150
    arrays = {k: v[:n] for k, v in arrays.items()}
    jcams, pcams = cameras(2, 32, 32)
    rng = np.random.default_rng(11)
    w_rgb, w_alpha, w_depth = (T(rng.normal(size=(2, 32, 32) + s).astype(np.float32))
                               for s in ((3,), (), ()))
    bg = T([0.2, 0.3, 0.4])

    def dense_loss(xs, views):
        loss = 0.0
        for v in views:
            proj = project_gaussians(xs["means3d"], xs["scales"], xs["quats"], pcams[v], 16)
            chans = torch.cat([xs["colors"], proj.depths[:, None]], dim=1)
            img, alpha = dense_render(proj.means2d, proj.depths, proj.conics, chans,
                                      xs["opacities"], proj.visible, proj.tiles_min,
                                      proj.tiles_max, 32, 32, 16)
            rgb = img[..., :3] + (1.0 - alpha[..., None]) * bg
            loss = loss + torch.sum(rgb * w_rgb[v]) + torch.sum(alpha * w_alpha[v]) \
                + torch.sum(img[..., 3] * w_depth[v])
        return loss

    def tiled_loss(xs, views):
        cfg = RasterizeConfig(tile_size=16, max_pairs=1 << 14)
        if len(views) == 1:
            out = rasterize(camera=pcams[0], bg_color=bg, config=cfg, **xs)
            out = {k: out[k][None] for k in ("image", "alpha", "depth")}
        else:
            out = rasterize_batched(cameras=pcams, bg_color=bg, config=cfg, **xs)
        return torch.sum(out["image"] * w_rgb[:len(views)]) \
            + torch.sum(out["alpha"] * w_alpha[:len(views)]) \
            + torch.sum(out["depth"] * w_depth[:len(views)])

    for views in ([0], [0, 1]):
        xs_t = {k: T(a, grad=True) for k, a in arrays.items()}
        xs_d = {k: T(a, grad=True) for k, a in arrays.items()}
        g_t = torch.autograd.grad(tiled_loss(xs_t, views), list(xs_t.values()))
        g_d = torch.autograd.grad(dense_loss(xs_d, views), list(xs_d.values()))
        for name, gt, gd in zip(xs_t, g_t, g_d):
            scale = max(float(gd.abs().max()), 1e-3)
            np.testing.assert_allclose(gt.numpy() / scale, gd.numpy() / scale, rtol=0,
                                       atol=2e-4, err_msg=f"{len(views)} views: {name}")

    proj = jax_project(*[jnp.asarray(arrays[k]) for k in ("means3d", "scales", "quats")],
                       jcams[0], 16)
    chans = jnp.concatenate([jnp.asarray(arrays["colors"]), proj.depths[:, None]], axis=1)
    want = jax_dense_render(proj.means2d, proj.depths, proj.conics, chans,
                            jnp.asarray(arrays["opacities"]), proj.visible, proj.tiles_min,
                            proj.tiles_max, 32, 32, 16)
    pp = Projected(*[T(np.asarray(x)) for x in proj])
    got = dense_render(pp.means2d, pp.depths, pp.conics, T(np.asarray(chans)),
                       T(arrays["opacities"]), pp.visible, pp.tiles_min, pp.tiles_max, 32, 32, 16)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The renderers' batched path
# ---------------------------------------------------------------------------


class PathSpy:
    """Counts the JAX renderer's single-pass calls."""

    def __init__(self, renderer):
        self.calls = 0
        inner = renderer._batch_forward_batched

        def spy(*a, **k):
            self.calls += 1
            return inner(*a, **k)

        renderer._batch_forward_batched = spy


GAUSSIAN_VARIANTS = dict(VARIANTS, plain=("diff-gaussian-rasterizer", ("comp_rgb",)))
# test_torch_renderers' scene at 32^2
SMALL = ["data.width=32", "data.height=32", "system.geometry.init_num_pts=150",
         "system.geometry.capacity=200"]


@pytest.mark.parametrize("variant", sorted(GAUSSIAN_VARIANTS))
def test_gaussian_variants_batched_match_jax(variant):
    """Each Gaussian renderer variant on the shading YAML's scene (two 32^2
    views, training: the JAX draws fed in) with batched=true in both
    packages, both on the single pass: outputs to 2e-5, gradients to 1e-4
    relative (test_torch_renderers' bounds)."""
    rtype, keys = GAUSSIAN_VARIANTS[variant]
    pair = make_pair(rtype, extra=SMALL + ["system.renderer.batched=true"])
    spy = PathSpy(pair.jsys.renderer)
    jout, jgrads, pout, pgrads = render_both(pair, True)
    assert spy.calls == 1 and pair.psys.renderer.path_counts == {("batched", True): 1}
    check_outputs_and_grads(jout, jgrads, pout, pgrads, keys)
    assert np.asarray(jout["n_pairs"]).tolist() == pout["n_pairs"].tolist()


def seeded_scene(rtype):
    """(renderer, state, batch, neural background params) of ``rtype``'s
    scene, the kernel background inverted at invert_bg_prob 0.5: the
    shading YAML's for a Gaussian variant, gs4d_motion's for the spacetime
    renderer, ``sugar_pair``'s for a SuGaR renderer."""
    if rtype == "diff-gaussian-rasterizer-spacetime":
        _, psys, _, state, batch = spacetime_scene()
        r, bg_params = psys.renderer, None
    elif rtype.startswith("diff-sugar-rasterizer-"):
        _, psys, _, state, _, batch = sugar_pair(rtype.endswith("-temporal"))
        r, bg_params = psys.renderer, None
    else:
        pair = make_pair(rtype, extra=SMALL)
        r, state, batch = pair.psys.renderer, pair.pstate.gauss, pair.batch
        bg_params = pair.pstate.extra_params.get("background")
    r.cfg.invert_bg_prob = 0.5
    return r, state, batch, bg_params


@pytest.mark.parametrize("rtype", ["diff-gaussian-rasterizer-advanced",
                                   "diff-gaussian-rasterizer-shading",
                                   "diff-gaussian-rasterizer-spacetime",
                                   "diff-sugar-rasterizer-normal",
                                   "diff-sugar-rasterizer-temporal"])
def test_batched_render_equals_loop_under_one_seed(rtype):
    """The port's single pass against its own per-view loop (the views in
    groups of one), the draws (the kernel background's inversion at
    invert_bg_prob 0.5, the neural background's and the material's) from
    generators of one seed: every output equal bit for bit and the
    generators left in one state, for each renderer family."""
    r, state, batch, bg_params = seeded_scene(rtype)
    outs, states = [], []
    for batched in (True, False):
        r.cfg.batched = batched
        gen = torch.Generator().manual_seed(5)
        r.path_counts.clear()
        outs.append(r.batch_forward(state, batch, bg_params=bg_params,
                                    generator=gen, training=True))
        assert r.path_counts == {("batched" if batched else "loop", True): 1}
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    for k in outs[1]:
        if k not in ("n_pairs", "n_dropped"):
            assert torch.equal(outs[0][k], outs[1][k]), k


SPACETIME_SCENE = ["data.height=32", "data.width=32", "data.random_camera.height=32",
                   "data.random_camera.width=32", "data.random_camera.batch_size=1",
                   "data.video_length=3", "data.num_frames=3", "system.geometry.num_frames=4",
                   "system.geometry.init_num_pts=200", "system.geometry.capacity=320",
                   "system.geometry.opacity_init=0.5", "system.renderer.tile_size=16",
                   "system.renderer.max_pairs=65536", "system.renderer.batched=true",
                   "system.renderer.adaptive_max_pairs=false"]


def spacetime_scene():
    """gs4d_motion's system in both packages on SPACETIME_SCENE, the JAX
    initial state with random temporal rows, scaling and rotation, in each
    package's form, and one training batch (three reference frames):
    (jsys, psys, jgauss, pgauss, batch)."""
    config = "gs4d_motion"
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{config}.yaml", SPACETIME_SCENE)
    pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{config}.yaml",
                       SPACETIME_SCENE)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    init = jax.device_get(jsys.init_state(0).gauss)
    rnd = random_spacetime_params(15, 320, 4)
    random_rows = pst.TEMPORAL_FIELDS + ("scaling", "rotation")
    params = {k: (rnd[k] if k in random_rows else np.asarray(v))
              for k, v in vars(init.params).items() if v is not None}
    jgauss = init.replace(params=jst.SpacetimeParams(**{k: jnp.asarray(v)
                                                        for k, v in params.items()}))
    pgauss = gaussian_state_from_numpy(jax.device_get(jgauss), "cpu")
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)
    return jsys, psys, jgauss, pgauss, batch


def test_spacetime_renderer_batched_matches_jax():
    """gs4d_motion's spacetime renderer with batched=true in both packages:
    the three reference frames (each at its own timestamp) in one pass,
    outputs to 2e-5, gradients into every trained field to 1e-4 relative
    (test_torch_spacetime's bounds)."""
    from test_torch_renderers import rel_l2

    jsys, psys, jgauss, pgauss, batch = spacetime_scene()
    spy = PathSpy(jsys.renderer)  # counts the one trace
    keys = ("comp_rgb", "comp_depth", "comp_mask")
    rng = np.random.default_rng(16)
    weights = {k: f32(rng.normal(size=(3, 32, 32, 3 if k == "comp_rgb" else 1))) for k in keys}
    jb = dict(to_device_batch(batch), height=32, width=32)

    def jloss(gp):
        out = jsys.renderer.batch_forward(jgauss.replace(params=gp), jb, training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in keys), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jgauss.params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pgauss.params.as_dict().items()}
    pout = psys.renderer.batch_forward(
        dataclasses.replace(pgauss, params=pst.SpacetimeParams(**leaves)), batch, training=False)
    assert spy.calls == 1 and psys.renderer.path_counts == {("batched", False): 1}
    sum(torch.sum(pout[k] * T(weights[k])) for k in keys).backward()
    for k in keys:
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=2e-5, err_msg=k)
    alive = np.asarray(jgauss.alive)
    for k in ("xyz", "features_dc", "scaling", "rotation", "opacity", "motion", "omega"):
        want = np.asarray(getattr(jg, k))[alive]
        assert np.abs(want).max() > 0, k
        assert rel_l2(leaves[k].grad.numpy()[alive], want) <= 1e-4, k


SUGAR_NAMES = ("comp_rgb", "comp_depth", "comp_mask", "comp_normal", "comp_normal_from_dist")


def sugar_pair(temporal):
    """sugar_static_refine.yaml's system on the bumpy icosphere with two
    32^2 random views, or sugar_dynamic.yaml's on the jittered icosphere
    with two 32^2 frames at their own times, batched=true in both
    packages; the JAX state with turned rotations and unequal scales."""
    common = ["system.renderer.tile_size=16", "system.renderer.batched=true",
              "system.renderer.max_pairs=65536"]
    if temporal:
        yaml = "sugar_dynamic"
        overrides = common + [
            "data.height=32", "data.width=32", "data.random_camera.height=32",
            "data.random_camera.width=32", "data.random_camera.batch_size=1",
            "data.video_length=4", "data.num_frames=2", f"system.geometry.n_dg_nodes={N_NODES}",
            f"system.geometry.num_frames={N_KNOTS}", "system.geometry.dg_node_connectivity=4"]
        verts, faces = jittered_sphere(9)
    else:
        yaml = "sugar_static_refine"
        overrides = common + [
            "data.image_path=", "data.height=32", "data.width=32",
            "data.random_camera.height=32", "data.random_camera.width=32",
            "data.random_camera.batch_size=2"]
        verts, faces = bumpy_sphere(5, degenerate=False)
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{yaml}.yaml", overrides)
    pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{yaml}.yaml", overrides)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    jsys.bind_mesh(verts, faces)
    psys.bind_mesh(verts, faces)
    jstate = jsys.init_state(0).gauss
    rng = np.random.default_rng(9)
    p = jstate.params

    def noise(a, s):
        return a + jnp.asarray(f32(rng.normal(size=a.shape) * s))

    moved = dict(scales=noise(p.scales, 0.3), complex_rot=noise(p.complex_rot, 1.0))
    if temporal:
        moved.update(node_trans=noise(p.node_trans, 0.05), node_rots=noise(p.node_rots, 0.3))
    jstate = jstate.replace(params=p.replace(**moved))
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)
    if not temporal:
        batch = batch["random_camera"]
    to_port = dynamic_sugar_state_from_numpy if temporal else sugar_state_from_numpy
    params_cls = pds.DynamicSuGaRParams if temporal else psugar.SuGaRParams
    return jsys, psys, jstate, to_port(jax.device_get(jstate), device="cpu"), params_cls, batch


@pytest.mark.parametrize("temporal", [False, True], ids=["static", "temporal"])
def test_sugar_renderers_batched_match_jax(temporal):
    """diff-sugar-rasterizer-normal (static mesh, two views) and
    -temporal (two frames at their own timestamps) with batched=true in
    both packages, both on the single pass, eval mode: every output to
    2e-5 (the depth's normals 5e-5), gradients of a weighted sum into every
    param to 1e-4 relative (L2), as test_torch_sugar holds the loop."""
    jsys, psys, jstate, pstate, params_cls, batch = sugar_pair(temporal)
    spy = PathSpy(jsys.renderer)
    h, w = int(batch["height"]), int(batch["width"])
    rng = np.random.default_rng(7)
    weights = {k: f32(rng.normal(size=(2, h, w, 1 if k in ("comp_depth", "comp_mask") else 3)))
               for k in SUGAR_NAMES}
    jb = dict(to_device_batch(batch), height=h, width=w)

    def jax_loss(params):
        out = jsys.renderer.batch_forward(jstate.replace(params=params), jb, training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in SUGAR_NAMES), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jstate.params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pstate.params.as_dict().items()}
    pout = psys.renderer.batch_forward(
        dataclasses.replace(pstate, params=params_cls(**leaves)), batch, training=False)
    assert spy.calls == 1 and psys.renderer.path_counts == {("batched", False): 1}
    for k in SUGAR_NAMES:
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=5e-5 if k == "comp_normal_from_dist" else 2e-5,
                                   err_msg=k)
    assert float(jout["comp_mask"].max()) > 0.5
    grads = torch.autograd.grad(sum(torch.sum(pout[k] * T(weights[k])) for k in SUGAR_NAMES),
                                list(leaves.values()), allow_unused=True)
    for k, g in zip(leaves, grads):
        if k == "sh_rest":
            assert g is None or g.numel() == 0
            continue
        want = np.asarray(getattr(jg, k), np.float64)
        assert np.linalg.norm(want) > 0, k
        assert np.linalg.norm(g.numpy() - want) <= 1e-4 * np.linalg.norm(want), k


# ---------------------------------------------------------------------------
# The gate and the controller
# ---------------------------------------------------------------------------

KI = 1024
GATE_TABLE = [
    # (batched, bs, per-view capacity, height, width)
    (True, 4, 256 * KI, 512, 512),  # gaussian_splatting.yaml once the controller shrank it
    (True, 4, 2**21, 512, 512),  # its start: past batched_max_pairs
    (True, 20, 256 * KI, 256, 256),  # gs4d's 20 views: the packed key does not fit
    (True, 20, 2**21, 256, 256),
    (True, 8, 256 * KI, 256, 256),  # 21 + 10 bits: fits
    (True, 8, 256 * KI, 512, 512),  # 21 + 12 bits: does not
    (True, 4, 65536, 64, 64),
    (True, 1, 65536, 64, 64),  # one view
    (True, 4, 512 * KI, 256, 256),
    (False, 4, 256 * KI, 512, 512),
]


def jax_gate(renderer, bs, height, width):
    """The JAX package's selection rule in GaussianRendererBase.batch_forward,
    on its own renderer and its own _batched_key_fits."""
    cap = renderer.max_pairs_override or renderer.cfg.max_pairs
    return bool(renderer.cfg.batched and bs > 1 and renderer.supports_batched
                and cap <= renderer.cfg.batched_max_pairs
                and renderer._batched_key_fits(bs, cap, height, width))


@pytest.mark.parametrize("renderer", ["diff-gaussian-rasterizer", "diff-sugar-rasterizer-normal",
                                      "diff-gaussian-rasterizer-spacetime"])
def test_gate_matches_jax(renderer):
    """The path each renderer takes over a table of (bs, capacity, H, W),
    the capacity as max_pairs and as the controller's override, against
    the JAX package's rule: 4 x 512^2 at 256 Ki single pass, gs4d's
    20 x 256^2 the loop."""
    seen = set()
    for batched, bs, cap, h, w in GATE_TABLE:
        for via_override in (False, True):
            cfg = {"tile_size": 32, "batched": batched}
            if not via_override:
                cfg["max_pairs"] = cap
            jr, pr = jfind(renderer)(dict(cfg)), pfind(renderer)(dict(cfg))
            if via_override:
                jr.max_pairs_override = pr.max_pairs_override = cap
            want = jax_gate(jr, bs, h, w)
            assert pr.use_batched(bs, h, w) == want, (renderer, batched, bs, cap, h, w)
            seen.add(want)
            if (bs, cap, h, w) == (4, 256 * KI, 512, 512):
                assert want == batched
            if (bs, h, w) == (20, 256, 256):
                assert not want
    assert seen == {True, False}


# (step, per-view demand, dropped): a shrink at step 0, growth on a drop,
# hysteresis, growth again, a shrink held back by the cooldown and taken
# after it, growth clipped at max_pairs; steps between the adaptations are
# logged and their peak counts
CONTROLLER_TRACE = [
    (0, 20000, 0), (1, 21000, 0), (25, 300000, 5000), (50, 280000, 0), (100, 300000, 0),
    (150, 100000, 0), (199, 900000, 10), (200, 50000, 0), (250, 50000, 0), (300, 40000, 0),
    (400, 50000, 0), (449, 3000000, 1), (450, 10, 0), (500, 10, 0), (850, 10, 0),
]


def test_controller_matches_jax():
    """Both systems' _adapt_pair_capacity fed one (demand, dropped) trace:
    the same capacity after every step and the same printed lines."""
    over = ["system.guidance_type=fake-sds-guidance", "system.geometry.init_num_pts=16",
            "system.geometry.capacity=32"]
    jsys = jfind("gaussian-splatting-system")(jax_load_config(
        f"{ROOT}/threestudio_3dgs_tpu/configs/gaussian_splatting.yaml", over).system)
    psys = pfind("gaussian-splatting-system")(load_config(
        f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gaussian_splatting.yaml", over).system,
        device="cpu")
    caps, lines = [], []
    for sys_ in (jsys, psys):
        out = io.StringIO()
        trace = []
        with contextlib.redirect_stdout(out):
            start = sys_._pair_capacity()
            for step, demand, dropped in CONTROLLER_TRACE:
                sys_._pair_log.append((demand, dropped))
                sys_._adapt_pair_capacity(step)
                trace.append(sys_._capacity)
        assert start == 2**21
        caps.append(trace)
        lines.append(out.getvalue().splitlines())
    assert caps[1] == caps[0]
    assert lines[1] == lines[0]
    assert len(set(caps[0])) >= 4 and len(lines[0]) >= 5
    assert caps[0][-1] == 256 * KI and max(caps[0]) == 2**21


def test_controller_runs_where_jax_runs_it():
    """The zero123 family's step keeps max_pairs in both packages; the
    base step (gaussian splatting, MVDream) adapts."""
    for name, adapts in (("gaussian-splatting-system", True),
                         ("gaussian-splatting-mvdream-system", True),
                         ("gaussian-splatting-zero123-system", False),
                         ("gaussian-splatting-4dgen-system", False),
                         ("sugar-static-system", False), ("sugar-4dgen-system", False)):
        jcls = jfind(name)
        uses_base_step = all(
            "train_step" not in vars(c) for c in jcls.__mro__[:jcls.__mro__.index(
                jbase.BaseGaussianSystem)])
        assert uses_base_step == adapts, name
        assert pfind(name).adapts_pair_capacity == adapts, name


# ---------------------------------------------------------------------------
# gaussian_splatting.yaml with its own batched / adaptive_max_pairs
# ---------------------------------------------------------------------------

BATCHED_STEPS = 3
# test_torch_train's scene with the YAML's batched and adaptive_max_pairs
# and its 2^21 ceiling; min_pairs cut to the patched bucket so that the
# capacity lands near this scene's demand
BATCHED_OVERRIDES = [o for o in OVERRIDES if not o.startswith((
    "system.renderer.adaptive_max_pairs", "system.renderer.batched",
    "system.renderer.max_pairs", "trainer.max_steps"))] + [
    f"trainer.max_steps={BATCHED_STEPS}", "system.renderer.min_pairs=2048"]
PATCHED = {"_ADAPT_EVERY": 2, "_BUCKET": 2048}


@pytest.fixture(scope="module")
def trained_batched(tmp_path_factory):
    """Both packages trained BATCHED_STEPS steps from the JAX initial state
    with the controller's step and bucket patched alike (it shrinks the
    capacity at step 0, so steps 1-3 take the single pass) and their
    printed lines captured."""
    root = tmp_path_factory.mktemp("batched")
    jax_cfg = f"{ROOT}/threestudio_3dgs_tpu/configs/gaussian_splatting.yaml"
    port_cfg = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gaussian_splatting.yaml"
    printed = []
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbase.BaseGaussianSystem, pbase.BaseGaussianSystem):
            for k, v in PATCHED.items():
                mp.setattr(cls, k, v)
        jt = JaxTrainer(jax_load_config(
            jax_cfg, BATCHED_OVERRIDES + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
        jt.state = jt.system.init_state(jt.cfg.seed)
        init = jax.device_get(jt.state.gauss)
        spy = PathSpy(jt.system.renderer)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jt.fit()
        printed.append(out.getvalue())
        pt = Trainer(load_config(port_cfg, BATCHED_OVERRIDES + [f"exp_root_dir={root / 'port'}"]),
                     device="cpu")
        pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            pt.fit()
        printed.append(out.getvalue())
        paths = dict(pt.system.renderer.path_counts)
    return jt, pt, init, printed, spy.calls, paths


def capacity_lines(text):
    return [line for line in text.splitlines() if line.startswith("[system] pair capacity")]


def test_batched_training_takes_the_single_pass(trained_batched):
    """The same capacity line in both packages at step 0, then the single
    pass for every later step in both (the JAX step is traced once per
    capacity, so its spy counts one single-pass trace)."""
    jt, pt, _, printed, jax_calls, paths = trained_batched
    lines = [capacity_lines(p) for p in printed]
    assert lines[0] == lines[1] and len(lines[0]) == 1, lines
    assert lines[0][0].startswith(f"[system] pair capacity {2**21} -> ")
    assert jax_calls == 1
    assert paths.get(("batched", True)) == BATCHED_STEPS - 1
    assert paths.get(("loop", True)) == 1
    assert pt.system.renderer.max_pairs_override == jt.system._capacity


def test_batched_training_logs_match_jax(trained_batched):
    jt, pt, _, _, _, _ = trained_batched
    assert len(jt.metrics_log) == len(pt.metrics_log) == BATCHED_STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        for k in keys:
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-9), k
        for k in ("n_pairs_max", "n_dropped_pairs", "gauss_num"):
            assert row_p[k] == row_j[k], k


@pytest.mark.parametrize("field", sorted(PARAM_ATOL))
def test_batched_trained_params_match_jax(trained_batched, field):
    """test_torch_train's bounds on the trained fields; the rotation
    through the covariance it gives each Gaussian, to 2e-3 of the
    Gaussian's largest entry (what the scaling's 1e-3 in log space allows,
    the covariance going with the square of the scales).  The initial
    field is isotropic, so the first rotation gradient is rounding, which
    Adam's normalisation turns into a step of either sign (ROADMAP section
    3): one such row flips in this run, and moves its covariance by 1e-4
    of its size."""
    jt, pt, init, _, _, _ = trained_batched
    jparams = jax.device_get(jt.state.gauss.params)
    if field == "rotation":
        alive = torch.tensor(np.asarray(init.alive))

        def cov(p):
            return covariance_from_scaling_rotation(pgf.get_scaling(p), pgf.get_rotation(p))[alive]

        want = cov(gaussian_state_from_numpy(jax.device_get(jt.state.gauss), "cpu").params)
        got = cov(pt.state.gauss.params)
        size = want.abs().amax(dim=(1, 2))
        assert bool(((got - want).abs().amax(dim=(1, 2)) <= 2e-3 * size).all())
        moved = np.abs(np.asarray(jparams.rotation) - np.asarray(init.params.rotation)).max()
        assert moved > 5 * PARAM_ATOL[field], moved
        return
    want = np.asarray(getattr(jparams, field))
    got = getattr(pt.state.gauss.params, field).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL[field])
    moved = np.abs(want - np.asarray(getattr(init.params, field))).max()
    assert moved > 5 * PARAM_ATOL[field], moved
