"""The port's SuGaR pieces against the JAX package on the CPU: ``rasterize``
with extra features and without depth, the plain twins of K1/K2 at 3, 7
and 8 channels against the Pallas kernels in interpret mode, ``ops/mesh``,
the SuGaR geometry's getters, both SuGaR renderers (outputs and gradients
into the mesh), ``fake-mse-guidance``, the state converter, and the
modules' isolation from JAX.  The same numpy inputs go through both
packages; the port's wrappers run their plain torch versions for CPU
tensors."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_rasterizer import make_scene
from test_torch_rasterizer import T, port_camera
from test_torch_train import ROOT

from threestudio_3dgs_tpu.models import sugar as jsugar
from threestudio_3dgs_tpu.ops import mesh as jmesh
from threestudio_3dgs_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from threestudio_3dgs_tpu.ops.rasterizer import rasterize as jax_rasterize
from threestudio_3dgs_tpu.ops.rasterizer.binning import bin_gaussians as jax_bin
from threestudio_3dgs_tpu.ops.rasterizer.blend_pallas import (
    blend_backward_pallas,
    blend_forward_pallas,
)
from threestudio_3dgs_tpu.ops.rasterizer.preprocess import project_gaussians as jax_project
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.models import sugar as psugar
from threestudio_3dgs_tpu_torch.models.convert import sugar_state_from_numpy, to_numpy
from threestudio_3dgs_tpu_torch.ops import mesh as pmesh
from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, blend, rasterize
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind


# ---------------------------------------------------------------------------
# rasterize: extra features, no depth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["extra3", "no_depth"])
def test_rasterize_channels_match_jax(case):
    """rgb + depth + 3 extra features (C = 7, SuGaR's layout), or rgb alone
    (C = 3): the outputs (extra is (H, W, 3), depth only with depth) to
    5e-6 and every input's gradient to 1e-4 of its largest, as
    test_torch_rasterizer holds C = 4."""
    means, scales, quats, opac, colors, cam = make_scene(n=300, seed=4)
    rng = np.random.default_rng(21)
    with_depth = case != "no_depth"
    extra = rng.normal(size=(300, 3)).astype(np.float32) if case == "extra3" else None
    h, w = cam.height, cam.width
    wts = {k: rng.normal(size=s).astype(np.float32)
           for k, s in (("image", (h, w, 3)), ("alpha", (h, w)), ("depth", (h, w)),
                        ("extra", (h, w, 3)))}
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    names = [k for k in ("image", "alpha", "depth", "extra")
             if (k != "depth" or with_depth) and (k != "extra" or extra is not None)]

    def jax_loss(m, s, q, o, c, e):
        out = jax_rasterize(m, s, q, o, cam, jnp.asarray(bg), colors=c, extra_features=e,
                            with_depth=with_depth,
                            config=JaxRasterizeConfig(tile_size=16, max_pairs=2**14, impl="jax"))
        return sum(jnp.sum(out[k] * wts[k]) for k in names), out

    args = [means, scales, quats, opac, colors] + ([jnp.asarray(extra)] if extra is not None
                                                   else [None])
    argnums = tuple(range(5 if extra is None else 6))
    (_, out_j), g_j = jax.jit(jax.value_and_grad(jax_loss, argnums=argnums, has_aux=True))(
        *args)
    leaves = [T(a, grad=True) for a in args if a is not None]
    out_p = rasterize(*leaves[:4], port_camera(cam), T(bg), colors=leaves[4],
                      extra_features=leaves[5] if extra is not None else None,
                      with_depth=with_depth, config=RasterizeConfig(tile_size=16, max_pairs=2**14))
    assert sorted(k for k in ("depth", "extra") if k in out_p) == \
        sorted(k for k in ("depth", "extra") if k in out_j)
    assert out_p["n_dropped"] == 0 and out_p["n_pairs"] == int(out_j["n_pairs"])
    for k in names:
        np.testing.assert_allclose(out_p[k].detach().numpy(), np.asarray(out_j[k]), rtol=0,
                                   atol=5e-6, err_msg=k)
    loss = sum(torch.sum(out_p[k] * T(wts[k])) for k in names)
    for name, gp, gj in zip(("means", "scales", "quats", "opacities", "colors", "extra"),
                            torch.autograd.grad(loss, leaves), g_j):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# K1 / K2's plain twins at other channel counts vs the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_channels", [3, 7, 8])
def test_blend_twins_match_pallas(n_channels):
    """A make_scene view binned by the JAX package, with rgb, the depth
    and random extra channels up to C: the plain twins against
    blend_forward_pallas / blend_backward_pallas in interpret mode, to the
    JAX package's own tolerance between those kernels and its XLA twin
    (1e-4, tests/test_blend_pallas.py: the kernel evaluates the exponent
    as a monomial matmul); the backward per column to 1e-4 of its
    largest."""
    ts = 16
    means, scales, quats, opac, colors, cam = make_scene(n=200, seed=n_channels)
    proj = jax_project(means, scales, quats, cam, ts)
    gx, gy = (cam.width + ts - 1) // ts, (cam.height + ts - 1) // ts
    bins = jax_bin(proj, gx, gy, 2**14, ts, opac)
    rng = np.random.default_rng(n_channels)
    chans = [colors] + ([proj.depths[:, None]] if n_channels > 3 else [])
    if n_channels > 4:
        chans.append(jnp.asarray(rng.normal(size=(200, n_channels - 4)).astype(np.float32)))
    chans = jnp.concatenate(chans, axis=1)
    feats = jnp.concatenate([proj.means2d, proj.conics, opac[:, None], chans], axis=1)
    n_valid = int(bins.tile_ranges[-1])
    pf = np.asarray(feats)[np.asarray(bins.pair_gauss)[:n_valid]]
    ranges = np.asarray(bins.tile_ranges)
    g_out = rng.normal(size=(gx * gy, ts * ts, n_channels + 1)).astype(np.float32)
    dims = (gx, gy, ts, n_channels)
    want = blend_forward_pallas(jnp.asarray(pf), jnp.asarray(ranges), *dims, interpret=True)
    got = blend.blend_forward(T(pf), T(ranges, torch.int64), *dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert float(np.asarray(want)[..., -1].max()) > 0.5
    want_g = np.asarray(blend_backward_pallas(jnp.asarray(pf), jnp.asarray(ranges), want,
                                              jnp.asarray(g_out), *dims, interpret=True))
    got_g = blend.blend_backward(T(pf), T(ranges, torch.int64), T(want), T(g_out), *dims)
    scale = np.abs(want_g).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(np.abs(got_g.numpy() - want_g).max(axis=0), 1e-4 * scale)


def test_blend_kernels_take_three_to_eight_channels():
    """The CUDA wrappers refuse a channel count the kernels are not built
    for (before the device check), and name the range."""
    for c in (2, 9):
        with pytest.raises(ValueError, match="3 to 8 channels"):
            blend._check_blend_args(torch.zeros((4, 6 + c)), torch.zeros(5, dtype=torch.int64),
                                    4, 16, c)
    assert list(blend.KERNEL_CHANNELS) == [3, 4, 5, 6, 7, 8]


# ---------------------------------------------------------------------------
# ops/mesh.py
# ---------------------------------------------------------------------------


def bumpy_sphere(seed=0, degenerate=True):
    """The 320-face icosphere with its vertices pushed in and out and, with
    `degenerate`, one degenerate face (two equal vertices) for the
    gradient-safe norms of the mesh ops (SuGaR's face frames, in the JAX
    package, give such a face NaN gradients)."""
    verts, faces = icosphere()
    rng = np.random.default_rng(seed)
    verts = verts * (1.0 + 0.1 * rng.uniform(-1, 1, size=(len(verts), 1))).astype(np.float32)
    if degenerate:
        verts[faces[0, 1]] = verts[faces[0, 0]]
    return verts, faces


def test_normals_match_jax():
    verts, faces = bumpy_sphere()
    for fn in ("face_normals", "vertex_normals"):
        want = np.asarray(getattr(jmesh, fn)(jnp.asarray(verts), jnp.asarray(faces)))
        got = getattr(pmesh, fn)(T(verts), torch.as_tensor(faces)).numpy()
        # cross products and a normalisation in f32: a few ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=fn)
    assert not np.abs(want).sum(-1).min() == 0  # vertex normals: none degenerate


def test_topology_matches_jax():
    verts, faces = bumpy_sphere()
    want = jmesh.build_topology(faces, len(verts))
    got = pmesh.build_topology(faces, len(verts))
    for k in ("edge_faces", "vert_nbr_idx", "vert_nbr_mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.edge_faces.shape == (480, 2)


@pytest.mark.parametrize("name", ["normal_consistency", "laplacian_smoothing"])
def test_smoothness_losses_match_jax(name):
    """The loss to 1e-6 relative and its gradient into the vertices to
    1e-5 of the largest (the degenerate face's zero normal passes zero
    gradient in both)."""
    verts, faces = bumpy_sphere(1)
    topo = jmesh.build_topology(faces, len(verts))
    if name == "normal_consistency":
        jfn = lambda v: jmesh.normal_consistency_loss(  # noqa: E731
            v, jnp.asarray(faces), jnp.asarray(topo.edge_faces))
        pfn = lambda v: pmesh.normal_consistency_loss(  # noqa: E731
            v, torch.as_tensor(faces), torch.as_tensor(topo.edge_faces))
    else:
        jfn = lambda v: jmesh.laplacian_smoothing_loss(  # noqa: E731
            v, jnp.asarray(topo.vert_nbr_idx), jnp.asarray(topo.vert_nbr_mask))
        pfn = lambda v: pmesh.laplacian_smoothing_loss(  # noqa: E731
            v, torch.as_tensor(topo.vert_nbr_idx), torch.as_tensor(topo.vert_nbr_mask))
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(verts))
    v = T(verts, grad=True)
    got = pfn(v)
    (got_g,) = torch.autograd.grad(got, v)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    want_g = np.asarray(want_g)
    assert np.isfinite(got_g.numpy()).all() and np.abs(want_g).max() > 0
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())


def test_prune_isolated_components_and_peel_match_jax():
    """Two spheres and a stray triangle: the larger component kept with the
    same remapped faces and attributes; an open grid's border rings
    peeled the same way."""
    big_v, big_f = icosphere(2)
    small_v, small_f = icosphere(1)
    verts = np.concatenate([small_v + 3.0, big_v, np.eye(3, dtype=np.float32) * 9.0])
    faces = np.concatenate([small_f, big_f + len(small_v),
                            np.array([[0, 1, 2]]) + len(small_v) + len(big_v)]).astype(np.int32)
    attrs = np.random.default_rng(2).uniform(size=verts.shape).astype(np.float32)
    want = jmesh.prune_isolated_components(verts, faces, attrs)
    got = pmesh.prune_isolated_components(verts, faces, attrs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == 320
    n = 6
    grid = [(i * (n + 1) + j, i * (n + 1) + j + 1, (i + 1) * (n + 1) + j)
            for i in range(n) for j in range(n)]
    grid += [(i * (n + 1) + j + 1, (i + 1) * (n + 1) + j + 1, (i + 1) * (n + 1) + j)
             for i in range(n) for j in range(n)]
    grid = np.asarray(grid, np.int32)
    for it in (1, 2, 5):
        want_m = jmesh.peel_border_faces(grid, it)
        np.testing.assert_array_equal(pmesh.peel_border_faces(grid, it), want_m)
    assert 0 < want_m.sum() < len(grid)


def test_pointcloud_normals_match_jax():
    """PCA normals of 300 noisy sphere points: the same unit vectors, the
    same orientation (to 1e-4: two 3x3 eigensolvers)."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3))
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True)
           * (1.0 + 0.01 * rng.normal(size=(300, 1)))).astype(np.float32)
    want = np.asarray(jmesh.estimate_pointcloud_normals(jnp.asarray(pts), 16))
    got = pmesh.estimate_pointcloud_normals(T(pts), 16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (np.sum(got * pts, axis=1) > 0.9).mean() > 0.95  # outward on the sphere


def test_load_obj_matches_jax(tmp_path):
    """Triangles, a quad and a pentagon (fan-triangulated), texture and
    normal indices, negative (relative) indices and comments."""
    path = tmp_path / "m.obj"
    path.write_text(
        "# test\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\nvt 0 0\nvn 0 0 1\n"
        "f 1 2 3\nf 1/1 2/1 3/1 4/1\nf -5//1 -4//1 -3//1 -2//1 -1//1\n")
    want = jmesh.load_obj(str(path))
    got = pmesh.load_obj(str(path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[1].shape == (6, 3)


# ---------------------------------------------------------------------------
# the SuGaR geometry and renderers
# ---------------------------------------------------------------------------


def models(n_per_face=6, **kw):
    """Both packages' SuGaR models bound to the bumpy icosphere with vertex
    colours, and the JAX initial state in both forms."""
    verts, faces = bumpy_sphere(4, degenerate=False)
    colors = np.random.default_rng(4).uniform(size=verts.shape).astype(np.float32)
    cfg = dict(n_gaussians_per_surface_triangle=n_per_face, **kw)
    jm, pm = jsugar.SuGaRModel(dict(cfg)), psugar.SuGaRModel(dict(cfg), device="cpu")
    jm.bind_mesh(verts, faces, colors)
    pm.bind_mesh(verts, faces, colors)
    jstate = jm.init_state(0)
    return jm, pm, jstate, sugar_state_from_numpy(jax.device_get(jstate), device="cpu")


@pytest.mark.parametrize("n_per_face", [1, 3, 4, 6])
def test_sugar_state_and_getters_match_jax(n_per_face):
    """init_state (the port's own, from the same mesh), the learning rates,
    and as_gaussian_arrays (positions, thickness + tangent scales, face
    frame rotations, opacities, SH, normals) of a state with random
    in-plane rotations, to 1e-6 (the quaternions from the 3x3 frames:
    2e-6)."""
    jm, pm, jstate, _ = models(n_per_face, sh_levels=2)
    own = to_numpy(pm.init_state(0))
    want = jax.device_get(jstate)
    for k in psugar.SuGaRParams.FIELDS:
        np.testing.assert_allclose(own["params"][k], np.asarray(getattr(want.params, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(own["faces"], np.asarray(want.faces))
    assert own["thickness"] == np.float32(want.thickness)
    rng = np.random.default_rng(n_per_face)
    params = want.params.replace(complex_rot=jnp.asarray(
        rng.normal(size=want.params.complex_rot.shape).astype(np.float32)))
    jstate = jstate.replace(params=params)
    pstate = sugar_state_from_numpy(jax.device_get(jstate), device="cpu")
    want_a = jax.jit(lambda st: jm.as_gaussian_arrays(st, 1.5))(jstate)
    got_a = pm.as_gaussian_arrays(pstate, 1.5)
    assert sorted(got_a) == sorted(want_a)
    for k, v in want_a.items():
        np.testing.assert_allclose(got_a[k].numpy(), np.asarray(v), rtol=0,
                                   atol=2e-6 if k == "quats" else 1e-6, err_msg=k)
    for step in (0, 500, 3000):
        want_lr, got_lr = jm.lr_tree(step), pm.lr_tree(step)
        for k in psugar.SuGaRParams.FIELDS:
            assert got_lr[k] == float(getattr(want_lr, k)), (step, k)


SUGAR_OUT = ("comp_rgb", "comp_depth", "comp_mask", "comp_normal", "comp_normal_from_dist")


@pytest.mark.parametrize("renderer", ["normal", "shading"])
def test_sugar_renderers_match_jax(renderer):
    """sugar_static_refine.yaml's system with diff-sugar-rasterizer-<renderer>
    (the shading one with the point-light material) on the bumpy icosphere,
    one 64^2 view in eval mode (no draws; the JAX side jitted): every
    output to 2e-5, the normals from the depth's finite differences to
    5e-5 (they amplify the depth's rounding, which XLA's fusion moves),
    and the gradients of a weighted sum of them into the mesh vertices and
    every other SuGaR param to 1e-4 relative (L2)."""
    overrides = ["data.image_path=", "data.height=64", "data.width=64",
                 "data.random_camera.height=64", "data.random_camera.width=64",
                 "data.random_camera.batch_size=1", "system.renderer.tile_size=16",
                 "system.renderer.batched=false", "system.renderer.max_pairs=65536",
                 f"system.renderer_type=diff-sugar-rasterizer-{renderer}"]
    if renderer == "shading":
        overrides.append("system.material_type=gaussian-diffuse-with-point-light-material")
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/sugar_static_refine.yaml",
                           overrides)
    pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_static_refine.yaml",
                       overrides)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    verts, faces = bumpy_sphere(5, degenerate=False)
    jsys.bind_mesh(verts, faces)
    psys.bind_mesh(verts, faces)
    jstate = jsys.init_state(0).gauss
    # unequal tangent scales and turned in-plane rotations: at the initial
    # state's equal scales the rotation's gradient is rounding
    rng = np.random.default_rng(6)
    p0 = jstate.params
    jstate = jstate.replace(params=p0.replace(
        scales=p0.scales + jnp.asarray(rng.normal(size=p0.scales.shape).astype(np.float32) * 0.3),
        complex_rot=jnp.asarray(rng.normal(size=p0.complex_rot.shape).astype(np.float32))))
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)["random_camera"]
    height, width = int(batch["height"]), int(batch["width"])
    rng = np.random.default_rng(7)
    weights = {k: rng.normal(size=(1, height, width, 3 if k in ("comp_rgb", "comp_normal",
                                                                  "comp_normal_from_dist")
                                   else 1)).astype(np.float32) for k in SUGAR_OUT}
    jb = dict(to_device_batch(batch), height=height, width=width)

    def jax_loss(params):
        out = jsys.renderer.batch_forward(jstate.replace(params=params), jb, training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in SUGAR_OUT), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jstate.params)
    pstate = sugar_state_from_numpy(jax.device_get(jstate), device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in pstate.params.as_dict().items()}
    import dataclasses

    pout = psys.renderer.batch_forward(
        dataclasses.replace(pstate, params=psugar.SuGaRParams(**leaves)), batch, training=False)
    for k in SUGAR_OUT:
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=5e-5 if k == "comp_normal_from_dist" else 2e-5,
                                   err_msg=k)
    assert int(pout["n_dropped"].sum()) == 0 and float(jout["comp_mask"].max()) > 0.5
    loss = sum(torch.sum(pout[k] * T(weights[k])) for k in SUGAR_OUT)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, grads):
        if k == "sh_rest":  # sh_levels 1: no rest bands
            assert g.numel() == 0
            continue
        want = np.asarray(getattr(jg, k), np.float64)
        got = g.numpy().astype(np.float64)
        assert np.linalg.norm(want) > 0, k
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), k


# ---------------------------------------------------------------------------
# fake-mse-guidance, the aliases, the converter and checkpoints, isolation
# ---------------------------------------------------------------------------


def test_fake_mse_guidance_matches_jax():
    rgb = np.random.default_rng(8).uniform(size=(2, 16, 24, 3)).astype(np.float32)
    cfg = {"target_color": [0.1, 0.7, 0.3]}
    want = jfind("fake-mse-guidance")(cfg)(jnp.asarray(rgb), None, {})
    x = T(rgb, grad=True)
    got = pfind("fake-mse-guidance")(cfg, device="cpu")(x, None, {})
    assert sorted(got) == sorted(want) == ["loss_sds"]
    assert float(got["loss_sds"]) == pytest.approx(float(want["loss_sds"]), rel=1e-6)
    want_g = np.asarray(jax.grad(lambda r: jfind("fake-mse-guidance")(cfg)(r, None, {})
                                 ["loss_sds"])(jnp.asarray(rgb)))
    (got_g,) = torch.autograd.grad(got["loss_sds"], x)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=1e-9)
    for name in ("stable-zero123-prompt-processor", "zero123-prompt-processor"):
        assert pfind(name) is pfind("dummy-prompt-processor")


def test_sugar_state_converter_and_checkpoint(tmp_path):
    """A JAX SuGaRState with Adam moments and count -> the port's, equal to
    the bit; saved and loaded as a port checkpoint, equal again."""
    jm, pm, jstate, _ = models(3)
    rng = np.random.default_rng(9)

    def noise(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), tree)

    adam = jstate.adam.replace(mu=noise(jstate.adam.mu), nu=noise(jstate.adam.nu),
                               count=jnp.int32(5))
    jstate = jstate.replace(params=noise(jstate.params), adam=adam)
    host = jax.device_get(jstate)
    got = to_numpy(sugar_state_from_numpy(host, device="cpu"))
    for k in psugar.SuGaRParams.FIELDS:
        np.testing.assert_array_equal(got["params"][k], np.asarray(getattr(host.params, k)))
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(got["adam"][m][k],
                                          np.asarray(getattr(getattr(host.adam, m), k)))
    assert got["adam"]["count"] == 5
    for k in ("faces", "bary", "thickness"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(host, k)))
    from threestudio_3dgs_tpu_torch.systems.base import SystemState

    save_checkpoint(str(tmp_path / "s.ckpt.npz"),
                    SystemState(gauss=sugar_state_from_numpy(host, device="cpu")), 7)
    state, step = load_checkpoint(str(tmp_path / "s.ckpt.npz"), "cpu")
    back = to_numpy(state.gauss)
    assert step == 7 and back["adam"]["count"] == 5
    for k in psugar.SuGaRParams.FIELDS:
        np.testing.assert_array_equal(back["params"][k], got["params"][k])
        np.testing.assert_array_equal(back["adam"]["nu"][k], got["adam"]["nu"][k])
    np.testing.assert_array_equal(back["faces"], got["faces"])


def test_bind_mesh_from_gaussian_stage_matches_jax(tmp_path):
    """The sugar stage's mesh from a gaussian-stage field: the JAX and port
    systems bound through ``geometry_convert_from`` to the field's PLY
    (written by the JAX package) bind the same mesh (vertices to 1e-5,
    faces and topology equal), and the port bound to its own checkpoint of
    that field binds it too."""
    from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy
    from threestudio_3dgs_tpu_torch.systems.base import SystemState

    over = ["data.image_path=", "system.geometry.init_num_pts=400",
            "system.geometry.capacity=512", "system.geometry.opacity_init=0.5"]
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/gs_to_sugar.yaml", over)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    field = jax.device_get(jsys.init_state(0).gauss)
    jsys.geometry.save_ply(field, str(tmp_path / "g.ply"))
    save_checkpoint(str(tmp_path / "g.ckpt.npz"),
                    SystemState(gauss=gaussian_state_from_numpy(field, device="cpu")), 9)
    bound = {}
    for src in ("g.ply", "g.ckpt.npz"):
        o = [f"system.geometry_convert_from={tmp_path / src}",
             "system.geometry.n_gaussians_per_surface_triangle=1"]
        pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_static_refine.yaml", o)
        bound[src] = pfind(pcfg.system_type)(pcfg.system, device="cpu").geometry
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/sugar_static_refine.yaml",
                           [f"system.geometry_convert_from={tmp_path / 'g.ply'}"])
    want = jfind(jcfg.system_type)(jcfg.system).geometry
    assert len(want._bound_mesh[1]) > 100
    for src, geo in bound.items():
        np.testing.assert_allclose(geo._bound_mesh[0], want._bound_mesh[0], rtol=0, atol=1e-5,
                                   err_msg=src)
        np.testing.assert_array_equal(geo._bound_mesh[1], want._bound_mesh[1], err_msg=src)
        np.testing.assert_array_equal(geo.topology.edge_faces, want.topology.edge_faces)


def test_sugar_modules_import_no_jax(tmp_path):
    """In a fresh interpreter, the SuGaR modules and one CPU step of each
    stage through the launcher (gs_to_sugar.yaml, then
    sugar_static_refine.yaml bound to an .obj) leave neither jax nor the
    JAX package in sys.modules."""
    verts, faces = icosphere(1)
    obj = tmp_path / "mesh.obj"
    with open(obj, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    small = ["trainer.max_steps=1", "data.image_path=", "data.height=32",
             "data.width=32", "data.random_camera.height=32", "data.random_camera.width=32",
             "data.random_camera.batch_size=1", "data.random_camera.eval_height=32",
             "data.random_camera.eval_width=32", "data.random_camera.n_test_views=1",
             "system.renderer.tile_size=16", "trainer.val_check_interval=0"]
    gauss = [f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gs_to_sugar.yaml", "--train",
             "--device", "cpu", f"exp_root_dir={tmp_path}/g", "system.geometry.init_num_pts=256",
             "system.sugar.n_samples_for_sdf_regularization=64"] + small
    sugar = [f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_static_refine.yaml", "--train",
             "--device", "cpu", f"exp_root_dir={tmp_path}/s", f"system.geometry_convert_from={obj}",
             "system.geometry.n_gaussians_per_surface_triangle=1"] + small
    code = (
        "import sys\n"
        "from threestudio_3dgs_tpu_torch import launch\n"
        "from threestudio_3dgs_tpu_torch.ops import mesh\n"
        "from threestudio_3dgs_tpu_torch.models import sugar\n"
        "from threestudio_3dgs_tpu_torch.renderers import sugar as r\n"
        "from threestudio_3dgs_tpu_torch.systems import sugar_static\n"
        f"launch.main(['--config'] + {gauss!r})\n"
        f"s = launch.main(['--config'] + {sugar!r})\n"
        "assert s.state.gauss.n_faces == 80\n"
        "bad = [m for m in ('jax', 'jaxlib', 'threestudio_3dgs_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())  # this process's share of the cores
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout and "train/loss_normal_consistency" in res.stdout
    assert "train/loss_density_regulation" in res.stdout
