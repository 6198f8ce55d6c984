"""The port's math core, projection, binning and ``rasterize`` against the
JAX package on the CPU (same numpy inputs through both; the port's
wrappers run their plain torch versions for CPU tensors)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_rasterizer import lookat_c2w, make_scene

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.ops import camera as jcam
from threestudio_3dgs_tpu.ops import gaussian_math as jgm
from threestudio_3dgs_tpu.ops import knn as jknn
from threestudio_3dgs_tpu.ops import quaternion as jquat
from threestudio_3dgs_tpu.ops import sh as jsh
from threestudio_3dgs_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from threestudio_3dgs_tpu.ops.rasterizer import rasterize as jax_rasterize
from threestudio_3dgs_tpu.ops.rasterizer.binning import bin_gaussians as jax_bin
from threestudio_3dgs_tpu.ops.rasterizer.preprocess import project_gaussians as jax_project

from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.ops import camera as pcam
from threestudio_3dgs_tpu_torch.ops import gaussian_math as pgm
from threestudio_3dgs_tpu_torch.ops import knn as pknn
from threestudio_3dgs_tpu_torch.ops import quaternion as pquat
from threestudio_3dgs_tpu_torch.ops import sh as psh
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from threestudio_3dgs_tpu_torch.ops.rasterizer.binning import bin_gaussians
from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import Projected, project_gaussians

PROJ_FIELDS = ("means2d", "depths", "conics", "radii", "tiles_min", "tiles_max", "visible")


def T(a, dtype=None, grad=False):
    t = torch.as_tensor(np.array(a), dtype=dtype)
    return t.requires_grad_(True) if grad else t


def port_camera(cam):
    """The JAX camera's exact matrices as a port camera."""
    return pcam.Camera(
        w2c=T(cam.w2c), full_proj=T(cam.full_proj), campos=T(cam.campos),
        tanfovx=float(cam.tanfovx), tanfovy=float(cam.tanfovy),
        znear=cam.znear, zfar=cam.zfar, height=cam.height, width=cam.width,
    )


def scene(case):
    """make_scene scenes; case 'culled' pushes a fifth of the Gaussians
    behind the camera and marks a tenth dead, as a capacity field has."""
    if case == "base":
        means, scales, quats, opac, colors, cam = make_scene(n=300, seed=0)
        alive = None
    else:
        means, scales, quats, opac, colors, cam = make_scene(n=400, seed=2, width=80)
        means = np.asarray(means).copy()
        means[::5] = means[::5] + np.array([0.0, -3.0, 0.0], np.float32)
        means = jnp.asarray(means)
        alive = jnp.asarray(np.arange(400) % 10 != 3)
    return means, scales, quats, opac, colors, cam, alive


# ---------------------------------------------------------------------------
# Math core
# ---------------------------------------------------------------------------


def test_camera_from_c2w_matches_jax():
    c2w = lookat_c2w([0.3, -2.5, 0.7])
    want = jcam.camera_from_c2w(jnp.asarray(c2w, jnp.float32), 1.1, 1.1, 48, 64)
    got = pcam.camera_from_c2w(c2w, 1.1, 1.1, 48, 64, device="cpu")
    # both build the 4x4s in f32; tan and the 4x4 product may round 1 ulp apart
    for name in ("w2c", "full_proj", "campos"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert got.tanfovx == pytest.approx(float(want.tanfovx), rel=1e-6)
    assert (got.height, got.width, got.znear, got.zfar) == (48, 64, 0.1, 100.0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_color_matches_jax(degree):
    rng = np.random.default_rng(degree)
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(50, k, 3)).astype(np.float32) * 0.5
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jsh.eval_sh_color(jnp.asarray(coeffs), jnp.asarray(dirs), degree))
    got = psh.eval_sh_color(T(coeffs), T(dirs), degree).numpy()
    # same polynomial, f32 rounding order only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(psh.rgb_to_sh(rgb), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               rtol=1e-6)


def test_quaternion_normalize_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    q[0] = 0.0  # the gradient-safe zero quaternion
    np.testing.assert_allclose(pquat.normalize(T(q)).numpy(),
                               np.asarray(jquat.normalize(jnp.asarray(q))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pquat.to_rotation_matrix(T(q)).numpy(),
                               np.asarray(jquat.to_rotation_matrix(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)


def test_gaussian_math_and_activations_match_jax():
    rng = np.random.default_rng(4)
    n = 40
    scales = np.exp(rng.normal(size=(n, 3)) - 2.0).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    want = jgm.covariance_from_scaling_rotation(jnp.asarray(scales), jnp.asarray(quats), 1.5)
    got = pgm.covariance_from_scaling_rotation(T(scales), T(quats), 1.5)
    # (R S)(R S)^T in f32: the off-diagonal sums cancel, so hold them to a
    # few ulp of the largest entry (~1.1) rather than of themselves
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pgm.strip_symmetric(got).numpy(),
                               np.asarray(jgm.strip_symmetric(want)), rtol=1e-5, atol=1e-6)
    x = rng.uniform(0.01, 0.99, size=n).astype(np.float32)
    np.testing.assert_allclose(pgm.inverse_sigmoid(T(x)).numpy(),
                               np.asarray(jgm.inverse_sigmoid(jnp.asarray(x))), rtol=1e-5)

    fields = dict(
        xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)) * 3,
        features_rest=rng.normal(size=(n, 3, 3)), scaling=rng.normal(size=(n, 3)) - 3,
        rotation=quats, opacity=rng.normal(size=(n, 1)),
    )
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    jp = jgf.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    pp = pgf.GaussianParams(**{k: T(v) for k, v in fields.items()})
    for name, j_val, p_val in (
        ("scaling", jgf.get_scaling(jp), pgf.get_scaling(pp)),
        ("scaling/sphere", jgf.get_scaling(jp, True), pgf.get_scaling(pp, True)),
        ("rotation", jgf.get_rotation(jp), pgf.get_rotation(pp)),
        ("opacity", jgf.get_opacity(jp), pgf.get_opacity(pp)),
        ("features", jgf.get_features(jp, 2.0), pgf.get_features(pp, 2.0)),
    ):
        np.testing.assert_allclose(p_val.numpy(), np.asarray(j_val), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_mean_knn_sq_dist_matches_jax():
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(700, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts), chunk=256))
    got = pknn.mean_knn_sq_dist(T(pts), chunk=256).numpy()
    # |a|^2 + |b|^2 - 2 a.b in f32 on both sides; the matrix product rounds
    # in another order: absolute error ~ eps * |a|^2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["base", "culled"])
def test_project_gaussians_matches_jax(case):
    means, scales, quats, opac, colors, cam, alive = scene(case)
    n = means.shape[0]
    rng = np.random.default_rng(7)
    offset = (rng.normal(size=(n, 2)) * 1e-3).astype(np.float32)
    cot = {
        "means2d": rng.normal(size=(n, 2)).astype(np.float32),
        "depths": rng.normal(size=(n,)).astype(np.float32),
        "conics": rng.normal(size=(n, 3)).astype(np.float32),
    }

    def jax_fn(m, s, q, off):
        p = jax_project(m, s, q, cam, 16, alive=alive, means2d_offset=off)
        return (p.means2d, p.depths, p.conics), p

    _, pullback, proj_j = jax.vjp(jax_fn, means, scales, quats, jnp.asarray(offset),
                                  has_aux=True)
    g_want = pullback(tuple(jnp.asarray(cot[k]) for k in ("means2d", "depths", "conics")))

    leaves = [T(means, grad=True), T(scales, grad=True), T(quats, grad=True), T(offset, grad=True)]
    proj_p = project_gaussians(*leaves[:3], port_camera(cam), 16,
                               alive=None if alive is None else T(alive),
                               means2d_offset=leaves[3])
    # f32 arithmetic in the same order; pixel coordinates ~64 carry ~1e-5
    # absolute rounding, conics up to ~3.3
    tol = {"means2d": 2e-5, "depths": 2e-6, "conics": 2e-5}
    for name in PROJ_FIELDS:
        got = getattr(proj_p, name).detach().numpy()
        ref = np.asarray(getattr(proj_j, name))
        if name in tol:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=tol[name], err_msg=name)
        else:  # integer / boolean fields: exact
            np.testing.assert_array_equal(got, ref, err_msg=name)
    if case == "culled":
        assert not proj_p.visible.all()

    loss = sum(torch.sum(getattr(proj_p, k) * T(cot[k])) for k in cot)
    g_got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("means", "scales", "quats", "means2d_offset"), g_got, g_want):
        w = np.asarray(w)
        # gradients relative to the field's largest entry: the chain of f32
        # products differs in rounding order between the two autodiffs
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)
        assert np.isfinite(g.numpy()).all(), name


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def _port_projected(p):
    return Projected(*(T(getattr(p, k)) for k in PROJ_FIELDS))


@pytest.mark.parametrize("tile_size,case,max_pairs", [
    (16, "base", 2**14), (32, "base", 2**14), (16, "culled", 2**14), (16, "base", 600),
])
def test_bin_gaussians_matches_jax(tile_size, case, max_pairs):
    """For every tile the same Gaussians in the same depth order, and equal
    pair accounting.  The last case drops pairs for capacity: both keep the
    first max_pairs in depth order."""
    means, scales, quats, opac, _, cam, alive = scene(case)
    proj = jax_project(means, scales, quats, cam, tile_size, alive=alive)
    gx = (cam.width + tile_size - 1) // tile_size
    gy = (cam.height + tile_size - 1) // tile_size
    want = jax_bin(proj, gx, gy, max_pairs, tile_size, opac)
    got = bin_gaussians(_port_projected(proj), gx, gy, max_pairs, tile_size, T(opac))
    assert got.n_pairs == int(want.n_pairs)
    assert got.n_dropped == int(want.n_dropped)
    assert (got.n_dropped > 0) == (max_pairs == 600)
    r_w = np.asarray(want.tile_ranges)
    r_g = got.tile_ranges.numpy()
    np.testing.assert_array_equal(r_g, r_w)
    np.testing.assert_array_equal(
        got.pair_gauss[: r_g[-1]].numpy(), np.asarray(want.pair_gauss)[: r_w[-1]]
    )


# ---------------------------------------------------------------------------
# rasterize: image, alpha, depth and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_size,sh_degree,case", [
    (16, None, "base"), (32, None, "base"), (16, 2, "culled"),
])
def test_rasterize_matches_jax(tile_size, sh_degree, case):
    means, scales, quats, opac, colors, cam, alive = scene(case)
    n = means.shape[0]
    rng = np.random.default_rng(11)
    if sh_degree is None:
        col = np.asarray(colors)
    else:
        col = (rng.normal(size=(n, (sh_degree + 1) ** 2, 3)) * 0.3).astype(np.float32)
    h, w = cam.height, cam.width
    wts = [rng.normal(size=s).astype(np.float32) for s in ((h, w, 3), (h, w), (h, w))]
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    color_kw = "colors" if sh_degree is None else "sh_coeffs"

    def jax_loss(m, s, q, o, c):
        out = jax_rasterize(
            m, s, q, o, cam, jnp.asarray(bg), **{color_kw: c}, sh_degree=sh_degree or 0,
            alive=alive, config=JaxRasterizeConfig(tile_size=tile_size, max_pairs=2**14, impl="jax"))
        loss = (jnp.sum(out["image"] * wts[0]) + jnp.sum(out["alpha"] * wts[1])
                + jnp.sum(out["depth"] * wts[2]))
        return loss, out

    args = (means, scales, quats, opac, jnp.asarray(col))
    (_, out_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)

    leaves = [T(a, grad=True) for a in args]
    out_p = rasterize(
        *leaves[:4], port_camera(cam), T(bg), **{color_kw: leaves[4]}, sh_degree=sh_degree or 0,
        alive=None if alive is None else T(alive),
        config=RasterizeConfig(tile_size=tile_size, max_pairs=2**14))
    assert out_p["n_dropped"] == 0 == int(out_j["n_dropped"])
    assert out_p["n_pairs"] == int(out_j["n_pairs"])
    # forward: the same pairs through the same chunked blend rule
    for name in ("image", "alpha", "depth"):
        np.testing.assert_allclose(out_p[name].detach().numpy(), np.asarray(out_j[name]),
                                   rtol=0, atol=5e-6, err_msg=name)
    np.testing.assert_array_equal(out_p["radii"].numpy(), np.asarray(out_j["radii"]))
    np.testing.assert_array_equal(out_p["visibility"].numpy(), np.asarray(out_j["visibility"]))

    loss = (torch.sum(out_p["image"] * T(wts[0])) + torch.sum(out_p["alpha"] * T(wts[1]))
            + torch.sum(out_p["depth"] * T(wts[2])))
    g_p = torch.autograd.grad(loss, leaves)
    names = ("means", "scales", "quats", "opacities", color_kw)
    for name, gp, gj in zip(names, g_p, g_j):
        gj = np.asarray(gj)
        # relative to the field's largest |g|: the JAX CPU reduction is a
        # cumsum difference over all pairs, the port sums each Gaussian's
        # rows directly, so long f32 sums round apart
        assert np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max(),
                                   err_msg=name)
