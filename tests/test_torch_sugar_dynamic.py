"""The port's dynamic SuGaR (threestudio_3dgs_tpu_torch: ops/dual_quaternion,
models/dynamic_sugar, models/geodesic, diff-sugar-rasterizer-temporal,
sugar-4dgen-system) and analytic-scene-sds-guidance against the JAX
package on the CPU.  The same numpy inputs, drawn from fixed seeds, go
through both packages (the JAX package on its CPU path, ``impl: "jax"``);
the port's rasterizer runs its plain twins for CPU tensors.

Tolerances, stated per test: the mesh topology builders exact (dtypes
included); the dual-quaternion algebra to 1e-6; the skinning, node
tracks and timed Gaussians (values 1e-5, gradients 1e-5 of their largest
entry); the skinning weights (indices equal, weights 1e-6 Euclidean
except on a node's own vertex, 1e-5 geodesic) on a jittered icosphere,
where no two nodes are equally far from a vertex; the geodesic distances
against the JAX package's C++ solver to 1e-5; one temporal render's
outputs to 2e-5 and its gradients to 1e-4 relative (L2), as
``tests/test_torch_sugar.py`` holds the static SuGaR renderers; the
analytic guidance's targets to 1e-6 and its losses to 1e-5 relative
with the JAX draws fed in; 3 training steps of sugar-4dgen-system
(discrete motion, DQS, spline, the inter-frame ARAP and 2D SDS, every
regulariser) with the JAX step draws fed in: losses to 1e-4 relative,
params as ``tests/test_torch_sugar_train.py`` holds the SuGaR stage (99%
of the rows to 2% of the learning rate, every row to 2 lr
a step, the in-plane rotation through the covariance)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_torch_mvdream import jax_draws
from test_torch_rasterizer import T
from test_torch_train import JAX_ONLY, ROOT

from threestudio_3dgs_tpu import native as jnative
from threestudio_3dgs_tpu.guidance import fake as jfake
from threestudio_3dgs_tpu.models import deformation as jdef
from threestudio_3dgs_tpu.models import dynamic_sugar as jds
from threestudio_3dgs_tpu.ops import dual_quaternion as jdq
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.guidance import fake as pfake
from threestudio_3dgs_tpu_torch.models import dynamic_sugar as pds
from threestudio_3dgs_tpu_torch.models import geodesic as pgeo
from threestudio_3dgs_tpu_torch.models.convert import (
    dynamic_sugar_state_from_numpy,
    flatten_tree,
    to_numpy,
)
from threestudio_3dgs_tpu_torch.ops import dual_quaternion as pdq
from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

N_NODES = 32
N_KNOTS = 5
SMALL_GRID = jdef.DeformationConfig(grid_resolution=(8, 8, 8, 5))  # the planes' sizes only


def jittered_sphere(seed=0):
    """The 320-face icosphere with every vertex moved by N(0, 0.01^2): no
    two nodes are equally far from a vertex."""
    verts, faces = icosphere()
    rng = np.random.default_rng(seed)
    return (verts + rng.normal(size=verts.shape) * 0.01).astype(np.float32), faces


def unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def assert_close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, err_msg=msg)


def assert_grads_close(got, want, rel, msg=""):
    """Every entry to ``rel`` of the largest entry of the JAX gradient."""
    want = np.asarray(want, np.float64)
    if want.size == 0:  # sh_rest at sh_levels 1
        assert got.numel() == 0, msg
        return
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got.detach().numpy().astype(np.float64) - want).max() <= rel * scale, msg


def assert_skin_weights_close(got_w, want_w, node_ids):
    """The vertices that are not nodes to 1e-6; a node's own vertex (first
    in its row): its self weight over 0.99 in both, the row to 1e-2."""
    is_node = np.zeros(len(want_w), bool)
    is_node[node_ids] = True
    assert_close(got_w[~is_node], want_w[~is_node], 1e-6)
    assert (got_w[node_ids, 0] > 0.99).all() and (want_w[node_ids, 0] > 0.99).all()
    assert_close(got_w[is_node], want_w[is_node], 1e-2)


# ---------------------------------------------------------------------------
# ops/dual_quaternion.py
# ---------------------------------------------------------------------------


def test_dual_quaternion_ops_match_jax():
    """Every function on random (unnormalised) quaternions and translations,
    to 1e-6; ``blend`` over 6 nodes where some hold the pivot's antipode
    (q and -q), one a quaternion orthogonal to the pivot (sign 0 counts as
    +1), and all of them antipodal pairs of one another."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    a = np.asarray(jdq.from_quat_translation(jnp.asarray(q), jnp.asarray(t)))
    b = np.asarray(jdq.from_quat_translation(jnp.asarray(q[::-1].copy()), jnp.asarray(t)))
    got_a = pdq.from_quat_translation(T(q), T(t))
    assert_close(got_a, a, 1e-6, "from_quat_translation")
    assert_close(pdq.multiply(T(a), T(b)), jdq.multiply(a, b), 1e-6, "multiply")
    assert_close(pdq.conjugate(T(a)), jdq.conjugate(a), 1e-6, "conjugate")
    raw = rng.normal(size=(64, 8)).astype(np.float32)
    raw[0, :4] = 0.0  # |q_r| below eps
    assert_close(pdq.normalize(T(raw)), jdq.normalize(raw), 1e-6, "normalize")
    for got, want in zip(pdq.to_quat_translation(T(a)), jdq.to_quat_translation(a)):
        assert_close(got, want, 1e-6, "to_quat_translation")
    assert_close(pdq.transform_point(T(a), T(p)), jdq.transform_point(a, p), 1e-6,
                 "transform_point")

    dqs = a[:60].reshape(10, 6, 8).copy()
    dqs[0, 1] = -dqs[0, 0]  # the pivot's antipode
    dqs[1, 1:] = -dqs[1, :1]  # every node the pivot's antipode
    dqs[2, 2, :4] = np.array([-dqs[2, 0, 1], dqs[2, 0, 0], -dqs[2, 0, 3], dqs[2, 0, 2]])  # dot 0
    dqs[3, 3:] = -dqs[3, :3]  # antipodal pairs
    w = rng.uniform(0.1, 1.0, size=(10, 6)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    assert float(np.sum(dqs[2, 2, :4] * dqs[2, 0, :4])) == 0.0
    assert_close(pdq.blend(T(dqs), T(w)), jdq.blend(dqs, w), 1e-6, "blend")


# ---------------------------------------------------------------------------
# mesh topology (the one-ring of the ARAP and Laplacian, shared edges)
# ---------------------------------------------------------------------------


def topology_case(case):
    verts, faces = icosphere(3)
    if case == "degenerate":  # a face with a repeated vertex, a duplicated face
        faces = faces.copy()
        faces[0, 1] = faces[0, 0]
        faces[5] = faces[7]
    elif case == "non_manifold":
        faces = np.random.default_rng(2).integers(0, 50, size=(400, 3)).astype(np.int32)
        return faces, 60
    elif case == "empty":
        return np.zeros((0, 3), np.int32), 5
    return faces, len(verts)


@pytest.mark.parametrize("case", ["icosphere", "degenerate", "non_manifold", "empty"])
def test_topology_matches_jax(case):
    """build_topology (shared edges in first-seen order, each its first two
    faces) and build_one_ring (neighbours in the order the JAX package's
    loop meets them, the width grown past max_degree) equal to the JAX
    package's, dtypes included, on meshes with repeated vertices,
    duplicated faces, edges of many faces, and none."""
    from threestudio_3dgs_tpu.ops import arap as jarap
    from threestudio_3dgs_tpu.ops import mesh as jmesh
    from threestudio_3dgs_tpu_torch.ops import arap as parap
    from threestudio_3dgs_tpu_torch.ops import mesh as pmesh

    faces, n_verts = topology_case(case)
    for want, got in zip(jmesh.build_topology(faces, n_verts),
                         pmesh.build_topology(faces, n_verts)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    for max_degree in (4, 16):
        for want, got in zip(jarap.build_one_ring(faces, n_verts, max_degree),
                             parap.build_one_ring(faces, n_verts, max_degree)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# skinning weights, geodesics
# ---------------------------------------------------------------------------


def test_skinning_weights_match_jax():
    """k-NN inverse-distance weights of 32 nodes (k = 4) on the jittered
    icosphere: indices equal, weights to 1e-6 on every vertex that is not
    a node.  A node's own vertex has a squared distance to it that is the
    rounding of |a|^2 + |b|^2 - 2 a.b (0 or ~1e-8, by the matrix product's
    summation order, which differs between the packages), so its weight
    1/max(d, 1e-6) lies anywhere in [1e4, 1e6]: there the self weight is
    over 0.99 in both packages and the row's weights agree to 1e-2."""
    verts, _ = jittered_sphere(1)
    node_ids = np.random.default_rng(1).choice(len(verts), N_NODES, replace=False)
    nodes = verts[node_ids]
    want_idx, want_w = jds.skinning_weights(verts, nodes, 4)
    got_idx, got_w = pds.skinning_weights(T(verts), T(nodes), 4)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got_idx.dtype == np.int32 and got_w.dtype == np.float32
    np.testing.assert_array_equal(want_idx[node_ids, 0], np.arange(N_NODES))
    assert_skin_weights_close(got_w, want_w, node_ids)


def test_geodesic_matches_jax_cpp():
    """The heat-method distances from 5 sources, the port's build of the
    same C++ against the JAX package's, to 1e-5; the geodesic skinning
    weights (indices equal, weights 1e-5); a solver failure raises."""
    assert jnative._get_lib() is not None, "the JAX package's C++ solver did not build"
    verts, faces = jittered_sphere(2)
    sources = np.array([0, 17, 40, 99, 150], np.int32)
    want = jnative.heat_geodesic_distances(verts, faces, sources)
    got = pgeo.heat_geodesic_distances(verts, faces, sources)
    assert got.shape == (5, len(verts)) and np.abs(want).max() > 0.5
    assert_close(got, want, 1e-5)
    want_idx, want_w = jds.skinning_weights_geodesic(verts, faces, sources, 3)
    got_idx, got_w = pds.skinning_weights_geodesic(verts, faces, sources, 3)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert_close(got_w, want_w, 1e-5)
    with pytest.raises(RuntimeError, match="heat_geodesic failed"):
        pgeo.heat_geodesic_distances(verts, faces[:0], sources)


# ---------------------------------------------------------------------------
# skinning, node tracks, blends (values and gradients)
# ---------------------------------------------------------------------------


def skin_inputs(seed=3, k=4):
    """Vertices, 32 nodes with translations and unit rotations, and a skin
    table in which vertex 0 takes node 0 and its antipode (node 1 holds
    -q_0), so DQS flips it."""
    verts, _ = jittered_sphere(seed)
    rng = np.random.default_rng(seed)
    nodes = verts[rng.choice(len(verts), N_NODES, replace=False)]
    node_t = (rng.normal(size=(N_NODES, 3)) * 0.05).astype(np.float32)
    node_q = unit_quats(rng, (N_NODES,))
    node_q[1] = -node_q[0]
    idx, w = jds.skinning_weights(verts, nodes, k)
    idx[0, :2] = [0, 1]
    return verts, nodes, node_t, node_q, idx, w


@pytest.mark.parametrize("method", ["lbs", "dqs"])
def test_skin_vertices_match_jax(method):
    """The skinned vertices to 1e-5 and the gradients of a weighted sum into
    the vertices, nodes, translations, rotations and weights to 1e-5 of
    their largest."""
    verts, nodes, node_t, node_q, idx, w = skin_inputs()
    wts = np.random.default_rng(4).normal(size=verts.shape).astype(np.float32)
    args = (verts, nodes, node_t, node_q, w)

    def jax_f(v, n, t, q, sw):
        out = jds.skin_vertices(v, n, t, q, jnp.asarray(idx), sw, method)
        return jnp.sum(out * wts), out

    (_, want), jg = jax.value_and_grad(jax_f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, args))
    leaves = [T(x, grad=True) for x in args]
    v, n, t, q, sw = leaves
    got = pds.skin_vertices(v, n, t, q, T(idx).long(), sw, method)
    assert_close(got.detach(), want, 1e-5)
    grads = torch.autograd.grad(torch.sum(got * T(wts)), leaves)
    for name, g, gj in zip(("verts", "nodes", "t", "q", "w"), grads, jg):
        assert_grads_close(g, gj, 1e-5, name)


@pytest.mark.parametrize("mode", ["spline", "per_frame"])
def test_node_tracks_match_jax(mode):
    """node_transforms_at and node_deltas_at at three times (frame 2 per
    frame), their gradients into the knots, then skin_vector_attrs and
    gaussian_vertex_blend of the deltas with theirs: 1e-5."""
    rng = np.random.default_rng(5)
    verts, faces = jittered_sphere(5)
    cfg = dict(use_spline=mode == "spline", num_frames=N_KNOTS)
    jcfg, pcfg = jds.DynamicSuGaRConfig(**cfg), pds.DynamicSuGaRConfig(**cfg)
    trans = (rng.normal(size=(N_NODES, N_KNOTS, 3)) * 0.1).astype(np.float32)
    rots = rng.normal(size=(N_NODES, N_KNOTS, 4)).astype(np.float32)
    scales = (rng.normal(size=(N_NODES, N_KNOTS, 3)) * 0.1).astype(np.float32)
    idx, w = jds.skinning_weights(verts, verts[:N_NODES], 4)
    bary = np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]],
                    np.float32)
    wts = [rng.normal(size=s).astype(np.float32)
           for s in ((N_NODES, 3), (N_NODES, 4), (len(faces) * 3, 3))]
    def jax_f(tr, ro, sc, ts):
        p = jds.DynamicSuGaRParams(points=None, sh_dc=None, sh_rest=None, scales=None,
                                   complex_rot=None, densities=None, node_trans=tr,
                                   node_rots=ro, node_scales=sc)
        xyz, q = jds.node_transforms_at(p, jcfg, ts, 2)
        nd = jds.node_deltas_at(sc, jcfg, ts, 2)
        g = jds.gaussian_vertex_blend(jds.skin_vector_attrs(nd, jnp.asarray(idx),
                                                            jnp.asarray(w)),
                                      jnp.asarray(faces), jnp.asarray(bary))
        outs = (xyz, q, g)
        return sum(jnp.sum(o * wt) for o, wt in zip(outs, wts)), outs

    jax_grad = jax.jit(jax.value_and_grad(jax_f, argnums=(0, 1, 2), has_aux=True))
    for ts in (0.0, 0.37, 1.0):
        (_, want), jg = jax_grad(jnp.asarray(trans), jnp.asarray(rots), jnp.asarray(scales),
                                 jnp.float32(ts))
        leaves = [T(x, grad=True) for x in (trans, rots, scales)]
        p = pds.DynamicSuGaRParams(points=None, sh_dc=None, sh_rest=None, scales=None,
                                   complex_rot=None, densities=None, node_trans=leaves[0],
                                   node_rots=leaves[1], node_scales=leaves[2])
        xyz, q = pds.node_transforms_at(p, pcfg, ts, 2)
        nd = pds.node_deltas_at(leaves[2], pcfg, ts, 2)
        g = pds.gaussian_vertex_blend(pds.skin_vector_attrs(nd, T(idx).long(), T(w)),
                                      T(faces).long(), T(bary))
        outs = (xyz, q, g)
        for name, o, oj in zip(("trans", "quat", "blend"), outs, want):
            assert_close(o.detach(), oj, 1e-5, f"{name} at {ts}")
        grads = torch.autograd.grad(sum(torch.sum(o * T(wt)) for o, wt in zip(outs, wts)),
                                    leaves)
        for name, gp, gj in zip(("trans", "rots", "scales"), grads, jg):
            assert_grads_close(gp, gj, 1e-5, f"{name} at {ts}")


# ---------------------------------------------------------------------------
# the geometry: init_state, lr_tree, timed Gaussians
# ---------------------------------------------------------------------------


def dynamic_models(seed=6, **kw):
    """Both packages' dynamic-sugar geometry bound to the jittered icosphere
    (32 nodes, k = 4, 5 knots, 6 Gaussians a face, d_scale and d_opacity),
    and the JAX initial state with random node tracks, scale and opacity
    deltas, tangent scales and in-plane rotations."""
    cfg = dict(n_dg_nodes=N_NODES, dg_node_connectivity=4, num_frames=N_KNOTS,
               n_gaussians_per_surface_triangle=6, d_opacity=True, **kw)
    jm = jds.DynamicSuGaRModel(dict(cfg))
    pm = pds.DynamicSuGaRModel(dict(cfg), device="cpu")
    verts, faces = jittered_sphere(seed)
    jm.bind_mesh(verts, faces)
    pm.bind_mesh(verts, faces)
    state = jm.init_state(0)
    rng = np.random.default_rng(seed)
    p = state.params

    def noise(a, s):
        return a + jnp.asarray((rng.normal(size=a.shape) * s).astype(np.float32))

    state = state.replace(params=p.replace(
        node_trans=noise(p.node_trans, 0.05), node_rots=noise(p.node_rots, 0.3),
        node_scales=noise(p.node_scales, 0.2), node_opacity=noise(p.node_opacity, 0.5),
        scales=noise(p.scales, 0.3), complex_rot=noise(p.complex_rot, 1.0)))
    return jm, pm, state


def test_dynamic_init_state_and_lrs_match_jax():
    """The port's own init_state from the same mesh: the node choice
    (``np.random.default_rng(0).choice``) and the skin indices equal, the
    weights as ``test_skinning_weights_match_jax`` holds them, the tracks
    zero with identity rotations, every param to 1e-6; the learning rates
    at three steps; the non-graph mode (every vertex its own node, weight
    1)."""
    jm, pm, _ = dynamic_models()
    want, got = jax.device_get(jm.init_state(0)), to_numpy(pm.init_state(0))
    np.testing.assert_array_equal(got["nodes_xyz"], np.asarray(want.nodes_xyz))
    np.testing.assert_array_equal(got["skin_idx"], np.asarray(want.skin_idx))
    node_ids = np.random.default_rng(0).choice(len(got["params"]["points"]), N_NODES,
                                               replace=False)
    np.testing.assert_array_equal(got["nodes_xyz"], got["params"]["points"][node_ids])
    assert_skin_weights_close(got["skin_w"], np.asarray(want.skin_w), node_ids)
    for k in pds.DynamicSuGaRParams.FIELDS:
        assert_close(got["params"][k], getattr(want.params, k), 1e-6, k)
    assert got["params"]["node_rots"].shape == (N_NODES, N_KNOTS, 4)
    for step in (0, 500, 3000):
        want_lr, got_lr = jm.lr_tree(step), pm.lr_tree(step)
        for k in got["params"]:
            assert got_lr[k] == float(getattr(want_lr, k)), (step, k)
    jm2, pm2, _ = dynamic_models(use_deform_graph=False)
    want2, got2 = jax.device_get(jm2.init_state(0)), to_numpy(pm2.init_state(0))
    for k in ("nodes_xyz", "skin_idx", "skin_w"):
        np.testing.assert_array_equal(got2[k], np.asarray(getattr(want2, k)))
    assert got2["params"]["node_trans"].shape[0] == len(got2["params"]["points"])


def deformation_params(seed=7):
    """The JAX deformation tree on small planes with its zero heads filled
    (so the position deltas move the mesh), flattened for the port."""
    tree = jdef.init_deformation_params(jax.random.PRNGKey(seed), SMALL_GRID)
    rng = np.random.default_rng(seed)
    for head in tree["head_pos"]:
        head["w"] = jnp.asarray((rng.normal(size=head["w"].shape) * 0.05).astype(np.float32))
        head["b"] = jnp.asarray((rng.normal(size=head["b"].shape) * 0.01).astype(np.float32))
    return tree


@pytest.mark.parametrize("mode", ["discrete_dqs", "discrete_lbs", "deformation"])
def test_timed_gaussians_match_jax(mode):
    """get_timed_gs_arrays at t = 0.4, frame 2 (spline in the discrete modes,
    the HexPlane network in "deformation"), every array to 1e-5 (the
    quaternions from the deformed face frames 2e-5), and the gradients of a
    weighted sum into every param (and the network's) to 1e-5 of their
    largest."""
    method = "lbs" if mode == "discrete_lbs" else "dqs"
    dyn = "deformation" if mode == "deformation" else "discrete"
    jm, pm, jstate = dynamic_models(skinning_method=method, dynamic_mode=dyn)
    tree = deformation_params() if dyn == "deformation" else None
    pstate = dynamic_sugar_state_from_numpy(jax.device_get(jstate), device="cpu")
    rng = np.random.default_rng(8)
    want_a = jax.jit(lambda st, tr: jm.get_timed_gs_arrays(st, 0.4, 2, tr, 1.5))(jstate, tree)
    wts = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in want_a.items()}

    def jax_f(params, tr):
        out = jm.get_timed_gs_arrays(jstate.replace(params=params), 0.4, 2, tr, 1.5)
        return sum(jnp.sum(out[k] * wts[k]) for k in out)

    jg_params, jg_tree = jax.jit(jax.grad(jax_f, argnums=(0, 1)))(jstate.params, tree)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pstate.params.as_dict().items()}
    ptree = None
    if tree is not None:
        ptree = {k: T(v, grad=True) for k, v in flatten_tree(jax.device_get(tree)).items()}
    got_a = pm.get_timed_gs_arrays(
        dataclasses.replace(pstate, params=pds.DynamicSuGaRParams(**leaves)), 0.4, 2, ptree, 1.5)
    assert sorted(got_a) == sorted(want_a)
    for k, v in want_a.items():
        assert_close(got_a[k].detach(), v, 2e-5 if k == "quats" else 1e-5, k)
    moved = np.abs(np.asarray(want_a["means3d"])
                   - np.asarray(jm.as_gaussian_arrays(jstate)["means3d"])).max()
    assert moved > 1e-3, moved
    inputs = list(leaves.values()) + (list(ptree.values()) if ptree else [])
    grads = torch.autograd.grad(sum(torch.sum(got_a[k] * T(wts[k])) for k in got_a), inputs,
                                allow_unused=True)
    want_g = [getattr(jg_params, k) for k in leaves]
    if ptree:
        flat = flatten_tree(jax.device_get(jg_tree))
        want_g += [flat[k] for k in ptree]
    for name, g, gj in zip(list(leaves) + list(ptree or ()), grads, want_g):
        if g is None:
            assert not np.any(np.asarray(gj)), name
            continue
        assert_grads_close(g, gj, 1e-5, name)


def test_temporal_render_matches_jax():
    """diff-sugar-rasterizer-temporal on sugar_dynamic.yaml's system (32
    nodes, DQS, spline) bound to the jittered icosphere, two 32^2 views at
    their own timestamps and frames, eval mode: every output to 2e-5
    (the depth's normals to 5e-5), the gradients of a weighted sum into
    every param to 1e-4 relative (L2)."""
    overrides = ["data.height=32", "data.width=32", "data.random_camera.height=32",
                 "data.random_camera.width=32", "data.random_camera.batch_size=1",
                 "data.video_length=4", "data.num_frames=2", "system.renderer.tile_size=16",
                 "system.renderer.batched=false", "system.renderer.max_pairs=65536",
                 f"system.geometry.n_dg_nodes={N_NODES}", f"system.geometry.num_frames={N_KNOTS}",
                 "system.geometry.dg_node_connectivity=4"]
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/sugar_dynamic.yaml", overrides)
    pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_dynamic.yaml", overrides)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    verts, faces = jittered_sphere(9)
    jsys.bind_mesh(verts, faces)
    psys.bind_mesh(verts, faces)
    jstate = jsys.init_state(0).gauss
    rng = np.random.default_rng(9)
    p = jstate.params

    def noise(a, s):
        return a + jnp.asarray((rng.normal(size=a.shape) * s).astype(np.float32))

    jstate = jstate.replace(params=p.replace(
        node_trans=noise(p.node_trans, 0.05), node_rots=noise(p.node_rots, 0.3),
        scales=noise(p.scales, 0.3), complex_rot=noise(p.complex_rot, 1.0)))
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)
    assert len(set(np.asarray(batch["timestamp"]).tolist())) == 2
    names = ("comp_rgb", "comp_depth", "comp_mask", "comp_normal", "comp_normal_from_dist")
    h, w = int(batch["height"]), int(batch["width"])
    weights = {k: rng.normal(size=(2, h, w, 1 if k in ("comp_depth", "comp_mask") else 3))
               .astype(np.float32) for k in names}
    jb = dict(to_device_batch(batch), height=h, width=w)

    def jax_loss(params):
        out = jsys.renderer.batch_forward(jstate.replace(params=params), jb, training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in names), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jstate.params)
    pstate = dynamic_sugar_state_from_numpy(jax.device_get(jstate), device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in pstate.params.as_dict().items()}
    pout = psys.renderer.batch_forward(
        dataclasses.replace(pstate, params=pds.DynamicSuGaRParams(**leaves)), batch,
        training=False)
    for k in names:
        assert_close(pout[k].detach(), jout[k], 5e-5 if k == "comp_normal_from_dist" else 2e-5, k)
    assert int(pout["n_dropped"].sum()) == 0 and float(jout["comp_mask"].max()) > 0.5
    grads = torch.autograd.grad(sum(torch.sum(pout[k] * T(weights[k])) for k in names),
                                list(leaves.values()), allow_unused=True)
    for k, g in zip(leaves, grads):
        want = np.asarray(getattr(jg, k), np.float64)
        if k == "sh_rest":
            assert g is None or g.numel() == 0
            continue
        assert np.linalg.norm(want) > 0, k
        got = g.numpy().astype(np.float64)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), k


# ---------------------------------------------------------------------------
# analytic-scene-sds-guidance
# ---------------------------------------------------------------------------


def test_analytic_scene_guidance_matches_jax():
    """The targets of four 64^2 random views to 1e-6 (the snowman in each);
    "mse" and "sds" losses (the JAX draws fed in), the grad_norm and each
    loss's gradient into the render to 1e-5 relative."""
    cfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gaussian_splatting.yaml",
                      ["data.width=64", "data.height=64", "data.batch_size=4"])
    batch = pfind(cfg.data_type)(cfg.data, seed=3).train_batch(0)
    jg = jfake.AnalyticSceneSDSGuidance({})
    pg = pfake.AnalyticSceneSDSGuidance({})
    want = np.asarray(jg.target_images(jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"])))
    got = pg.target_images(T(batch["rays_o"]), T(batch["rays_d"]))
    assert_close(got, want, 1e-6)
    assert (want.reshape(4, -1, 3).max(1) > 0.5).all()  # the snowman is in every view
    rgb = np.random.default_rng(10).uniform(size=want.shape).astype(np.float32)
    for mode in ("mse", "sds"):
        jg.cfg.mode = pg.cfg.mode = mode
        key = jax.random.PRNGKey(11)
        sched = jg.sched_scalars(0)

        def jax_loss(x):
            out = jg(x, None, batch, key=key, sched=sched)
            return out["loss_sds"], out

        (_, jout), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(rgb))
        t, noise = jax_draws(key, sched, 4, 1, rgb.shape)
        x = T(rgb, grad=True)
        pout = pg(x, None, batch, sched=pg.sched_scalars(0), draws={"t": t, "noise": T(noise)})
        assert float(pout["loss_sds"].detach()) == pytest.approx(float(jout["loss_sds"]), rel=1e-5)
        if mode == "sds":
            assert float(pout["grad_norm"]) == pytest.approx(float(jout["grad_norm"]), rel=1e-5)
        g = torch.autograd.grad(pout["loss_sds"], x)[0].numpy()
        assert np.linalg.norm(g - np.asarray(jgrad)) <= 1e-5 * np.linalg.norm(np.asarray(jgrad))


# ---------------------------------------------------------------------------
# sugar-4dgen-system: 3 training steps
# ---------------------------------------------------------------------------

STEPS = 3
LR_FRACTION = 0.02
# sugar_dynamic.yaml (discrete motion, DQS, spline) configured as the JAX
# package's own 4D SuGaR smoke test: 32 nodes, k = 4, 6 knots, 32^2 views,
# tile 16, the inter-frame substep (3 times) every step, the 2D SDS, every
# regulariser; min_step_percent == max_step_percent so the analytic priors'
# noise cancels, and invert_bg_prob 1 (never inverts)
TRAIN = [
    f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
    "data.height=32", "data.width=32", "data.resolution_milestones=[]", "data.video_length=4",
    "data.num_frames=2", "data.random_camera.height=32", "data.random_camera.width=32",
    "data.random_camera.batch_size=1",
    f"system.geometry.n_dg_nodes={N_NODES}", "system.geometry.dg_node_connectivity=4",
    "system.geometry.num_frames=6", "system.renderer.tile_size=16",
    "system.renderer.max_pairs=32768", "system.renderer.batched=false",
    "system.renderer.adaptive_max_pairs=false",
    "system.guidance_zero123.num_frames=4", "system.guidance_zero123.min_step_percent=0.5",
    "system.guidance_zero123.max_step_percent=0.5",
    "system.guidance_2d_type=fake-sds-guidance",
    "system.guidance_2d={target_color: [0.5, 0.5, 0.5], min_step_percent: 0.5, "
    "max_step_percent: 0.5}",
    "system.num_inter_frames=3", "system.freq.inter_frame_reg=1",
    "system.freq.milestone_inter_frame_reg=0",
    "system.loss.lambda_sds_zero123=0.1", "system.loss.lambda_rgb=1000.0",
    "system.loss.lambda_mask=100.0", "system.loss.lambda_normal_consistency=0.1",
    "system.loss.lambda_laplacian_smoothing=0.1", "system.loss.lambda_arap_reg=0",
    "system.loss.lambda_arap_reg_key_frame=1.0", "system.loss.lambda_arap_reg_inter_frame=1.0",
    "system.loss.lambda_sds_2d=0.05", "system.loss.lambda_ref_xyz=1.0",
    "system.loss.lambda_obj_centric=0.1", "system.loss.lambda_rgb_tv=1.0",
    "system.loss.lambda_depth_tv=1.0", "system.loss.lambda_normal_tv=1.0",
    "system.loss.lambda_normal_depth_consistency=1.0",
]
TRAIN_LOGS = {"train/loss_zero123_sds", "train/loss_ref_rgb", "train/psnr", "train/loss_rgb_tv",
              "train/loss_normal_tv", "train/loss_normal_depth_consistency",
              "train/loss_normal_consistency", "train/loss_laplacian_smoothing",
              "train/loss_arap_reg", "train/loss_arap_reg_inter_frame",
              "train/loss_interf_sds_2d", "train/loss_ref_xyz", "train/loss_obj_centric"}


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)


def jax_4d_draws(seed, steps):
    """Per step, the uniforms the JAX step draws from its key: past the
    zero123 substep's (render, guidance) and the ref substep's render key,
    the mesh losses' ARAP time, then the inter-frame window's start."""
    key = jax.random.PRNGKey(seed)
    out = {}
    for step in range(steps):
        key, k = jax.random.split(key)
        k = jax.random.split(k, 3)[0]
        k = jax.random.split(k)[0]
        k, k_m = jax.random.split(k)
        k, k_if = jax.random.split(k)
        out[step] = {"arap_t": np.asarray(jax.random.uniform(jax.random.split(k_m)[0])),
                     "inter_frame_start": np.asarray(
                         jax.random.uniform(jax.random.split(k_if, 3)[0]))}
    return out


def perturbed(params, seed):
    """The initial params with the node tracks off the rest pose (+ N(0,
    0.01^2) translations, N(0, 0.05^2) on the rotations and scale deltas)
    and the tangent scales unequal (+ N(0, 0.3^2)).  At the rest pose the
    ARAP energy is rounding (~1e-15), so a knot that no render reaches (a
    frame outside the step's sample) takes only its rounding gradient,
    which Adam turns into a step of +-lr in either package; with equal
    tangent scales so does the in-plane rotation (ROADMAP section 3)."""
    rng = np.random.default_rng(seed)

    def noise(a, s):
        return a + jnp.asarray((rng.normal(size=a.shape) * s).astype(np.float32))

    return params.replace(node_trans=noise(params.node_trans, 0.01),
                          node_rots=noise(params.node_rots, 0.05),
                          node_scales=noise(params.node_scales, 0.05),
                          scales=noise(params.scales, 0.3))


@pytest.fixture(scope="module")
def trained_4d(tmp_path_factory):
    """Both packages' sugar-4dgen-system trained STEPS steps on the jittered
    icosphere (bound through surface_mesh_to_bind_path) from the JAX
    initial state, ``perturbed``, with its skin tables, the port fed the
    JAX draws."""
    root = tmp_path_factory.mktemp("sugar4d")
    verts, faces = jittered_sphere(12)
    write_obj(root / "mesh.obj", verts, faces)
    over = TRAIN + [f"system.geometry.surface_mesh_to_bind_path={root / 'mesh.obj'}"]
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/sugar_dynamic.yaml",
                                    over + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_dynamic.yaml",
                             over + [f"exp_root_dir={root / 'port'}"]), device="cpu")
    state = jt.system.init_state(jt.cfg.seed)
    jt.state = state.replace(gauss=state.gauss.replace(params=perturbed(state.gauss.params, 13)))
    init = jax.device_get(jt.state.gauss)
    pt.state = SystemState(gauss=dynamic_sugar_state_from_numpy(init, device="cpu"))
    pt.system.step_draws = jax_4d_draws(jt.cfg.seed, STEPS).get
    jt.fit()
    pt.fit()
    return jt, pt, init


def test_4d_training_logs_match_jax(trained_4d):
    """Every train/ log of each step to 1e-4 relative, the expected ones
    among them, no dropped pairs; the port's own init_state equals the
    JAX package's."""
    jt, pt, init = trained_4d
    assert len(jt.metrics_log) == len(pt.metrics_log) == STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert TRAIN_LOGS <= set(keys), TRAIN_LOGS - set(keys)
        for k in keys:
            assert np.isfinite(row_p[k])
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), k
        assert row_p["n_dropped_pairs"] == 0
    own = to_numpy(pt.system.init_state(0).gauss)
    np.testing.assert_array_equal(own["skin_idx"], np.asarray(init.skin_idx))
    np.testing.assert_array_equal(own["nodes_xyz"], np.asarray(init.nodes_xyz))


def test_4d_trained_params_match_jax(trained_4d):
    """Each param: 99% of the rows within 2% of its learning rate of the
    JAX package's, every row within 2 lr per step, having moved by more
    than half its learning rate; the in-plane rotation through the
    covariance of the canonical Gaussians; the buffers and the Adam count
    unchanged."""
    jt, pt, init = trained_4d
    want_state, got = jax.device_get(jt.state.gauss), to_numpy(pt.state.gauss)
    lrs = pt.system.geometry.lr_tree(0)
    for field in ("points", "sh_dc", "scales", "densities", "node_trans", "node_rots",
                  "node_scales"):
        lr = lrs[field]
        want = np.asarray(getattr(want_state.params, field))
        diff = np.abs(got["params"][field] - want).reshape(want.shape[0], -1).max(-1)
        assert (diff <= LR_FRACTION * lr).mean() >= 0.99, (field, np.sort(diff)[-5:])
        assert diff.max() <= 2 * lr * STEPS, field
        before = np.asarray(getattr(init.params, field))
        assert np.abs(want - before).max() > 0.5 * lr, field
    geo = pt.system.geometry

    def covs(state):
        arrays = geo.as_gaussian_arrays(state)
        return covariance_from_scaling_rotation(arrays["scales"], arrays["quats"]).numpy()

    want_cov = covs(dynamic_sugar_state_from_numpy(want_state, device="cpu"))
    np.testing.assert_allclose(covs(pt.state.gauss), want_cov, rtol=0,
                               atol=1e-4 * np.abs(want_cov).max())
    for k in ("faces", "bary", "nodes_xyz", "skin_idx", "skin_w"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want_state, k)), k)
    assert got["adam"]["count"] == int(want_state.adam.count) == STEPS


# ---------------------------------------------------------------------------
# the launcher, checkpoints and --resume; isolation from JAX
# ---------------------------------------------------------------------------


def test_deformation_yaml_resume_and_isolation(tmp_path):
    """sugar_dynamic_dg_zero123.yaml (deformation motion, DQS, d_scale) at a
    small size through the launcher on the CPU, bound to an .obj: in a
    fresh interpreter, 2 steps and the test renders, leaving neither jax
    nor the JAX package in sys.modules; the checkpoint's dynamic state
    (node tracks, skin tables, the deformation network) read back equal
    to the run's; the network's head biases, the only deformation params
    with a gradient at the start, and the scale tracks moved; --resume
    continuing at its step."""
    verts, faces = icosphere(1)
    write_obj(tmp_path / "mesh.obj", verts, faces)
    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_dynamic_dg_zero123.yaml"
    flags = ["--config", config, "--device", "cpu"]
    over = [f"system.geometry.surface_mesh_to_bind_path={tmp_path / 'mesh.obj'}",
            "system.geometry.n_gaussians_per_surface_triangle=1", "system.geometry.n_dg_nodes=16",
            "system.geometry.num_frames=4", "data.video_length=4", "data.num_frames=2",
            "data.height=32", "data.width=32", "data.random_camera.height=32",
            "data.random_camera.width=32", "data.random_camera.batch_size=1",
            "data.random_camera.eval_height=32", "data.random_camera.eval_width=32",
            "data.random_camera.n_test_views=2", "system.guidance_zero123.num_frames=4",
            "system.renderer.tile_size=16", "trainer.val_check_interval=0"]
    first = flags + ["--train", "trainer.max_steps=2", f"exp_root_dir={tmp_path / 'a'}"] + over
    code = (
        "import sys\n"
        "from threestudio_3dgs_tpu_torch import launch\n"
        f"t = launch.main({first!r})\n"
        "bad = [m for m in ('jax', 'jaxlib', 'threestudio_3dgs_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ISOLATED', t.save_dir)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())  # this process's share of the cores
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout and "train/loss_arap_reg" in res.stdout
    save_dir = res.stdout.split("ISOLATED ")[-1].strip()
    assert len(os.listdir(f"{save_dir}/save/it2-test")) == 2
    ckpt = f"{save_dir}/ckpts/last.ckpt.npz"
    state, step = load_checkpoint(ckpt, "cpu")
    assert step == 2 and isinstance(state.gauss, pds.DynamicSuGaRState)
    assert state.gauss.skin_idx.shape == (len(verts), 16) and state.gauss.adam.count == 2
    fresh = launch.main(flags + [f"exp_root_dir={tmp_path / 'c'}"] + over).system
    init = fresh.init_state(0)
    for k in ("nodes_xyz", "skin_idx", "skin_w", "faces"):
        assert torch.equal(getattr(state.gauss, k), getattr(init.gauss, k)), k
    assert float((state.gauss.params.node_scales - init.gauss.params.node_scales).abs().max()) > 0
    assert float(state.gauss.params.node_trans.abs().max()) == 0.0  # unused in this mode
    moved = {k for k, v in state.extra_params["deformation"].items()
             if not torch.equal(v, init.extra_params["deformation"][k])}
    heads = {"head_pos", "head_scale", "head_rot", "head_opacity"}
    assert moved and all(k.split("/")[0] in heads and k.endswith("/b") for k in moved), moved
    resumed = launch.main(flags + ["--train", "--resume", ckpt, "trainer.max_steps=3",
                                   f"exp_root_dir={tmp_path / 'b'}"] + over)
    assert resumed.step == 3 and resumed.state.gauss.adam.count == 3
    assert resumed.state.extra_opt.count == 3
    assert len(resumed.metrics_log) == 1 and np.isfinite(resumed.metrics_log[0]["train/loss_total"])
