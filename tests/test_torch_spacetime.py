"""The port's 4D building blocks against the JAX package on the CPU: the
Lie-group and spline ops, the HexPlane deformation, the spacetime field's
timed evaluation in its four motion modes, its structural ops and temporal
PLY, the temporal data module, the spacetime renderer, the ARAP energy and
SuGaR's regularisers.

Inputs are drawn with numpy from fixed seeds and given to both packages;
where the JAX package draws (the split children, the cap-prune, SuGaR's
samples) its own draws, recomputed here from its key, reach the port
through ``draws=``.  Values are held to a few f32 ulps of their scale
(stated per test); gradients, of a random weighting of every output, to
1e-5 relative L2 (1e-4 through the rasterizer, as
tests/test_torch_renderers.py holds them)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from threestudio_3dgs_tpu.data import temporal_image as jtd
from threestudio_3dgs_tpu.models import deformation as jdef
from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.models import optim as joptim
from threestudio_3dgs_tpu.models import spacetime as jst
from threestudio_3dgs_tpu.ops import arap as jarap
from threestudio_3dgs_tpu.ops import lie as jlie
from threestudio_3dgs_tpu.ops import spline as jspline
from threestudio_3dgs_tpu.ops import sugar_reg as jsugar
from threestudio_3dgs_tpu.ops.camera import camera_from_c2w as jcamera
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.data import temporal_image as ptd
from threestudio_3dgs_tpu_torch.models import deformation as pdef
from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models import spacetime as pst
from threestudio_3dgs_tpu_torch.models.convert import (
    flatten_tree, gaussian_state_from_numpy, to_numpy)
from threestudio_3dgs_tpu_torch.ops import arap as parap
from threestudio_3dgs_tpu_torch.ops import lie as plie
from threestudio_3dgs_tpu_torch.ops import spline as pspline
from threestudio_3dgs_tpu_torch.ops import sugar_reg as psugar
from threestudio_3dgs_tpu_torch.ops.camera import camera_from_c2w as pcamera
from threestudio_3dgs_tpu_torch.ops.knn import knn as pknn
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

from test_torch_renderers import rel_l2
from test_torch_train import ROOT

GRAD_REL = 1e-5


def f32(x):
    return np.asarray(x, np.float32)


def unflatten_tree(flat):
    """The inverse of ``flatten_tree``: the JAX package's nested tree (lists
    where the path parts are integers) of the port's flat names."""
    root = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def both_grads(jfn, pfn, inputs, seed=0):
    """Values of jfn / pfn on the numpy ``inputs`` and the gradients of a
    random weighting of every output w.r.t. every input, in both
    packages: ((jax outs, jax grads), (port outs, port grads))."""
    jouts = jax.jit(jfn)(*[jnp.asarray(x) for x in inputs])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    rng = np.random.default_rng(seed)
    weights = [f32(rng.normal(size=np.shape(o))) for o in jouts]

    def jloss(*xs):
        outs = jfn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(len(inputs)))))(
        *[jnp.asarray(x) for x in inputs])
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    pouts = pfn(*xs)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    sum(torch.sum(o * torch.tensor(w)) for o, w in zip(pouts, weights)).backward()
    return ([np.asarray(o) for o in jouts], [np.asarray(g) for g in jgrads],
            [o.detach().numpy() for o in pouts],
            [np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy() for x in xs])


def assert_pair(result, atol, grad_rel=GRAD_REL):
    jouts, jgrads, pouts, pgrads = result
    for got, want in zip(pouts, jouts):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for got, want in zip(pgrads, jgrads):
        assert np.isfinite(got).all()
        assert rel_l2(got, want) <= grad_rel


# ---------------------------------------------------------------------------
# ops/lie.py, ops/spline.py
# ---------------------------------------------------------------------------

def lie_inputs(seed, width):
    """Rows of random magnitudes, with the identity and a 1e-7 rotation
    (the Taylor branches) among them."""
    x = np.random.default_rng(seed).normal(size=(12, width)) * 0.8
    x[0] = 0.0
    x[1] = 1e-7
    return f32(x)


def unit_quats(seed, n=12):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q[0] = [1, 0, 0, 0]  # the identity
    q[1] = [-0.9, 0.1, 0.2, 0.0]  # w < 0: the principal branch
    return f32(q / np.linalg.norm(q, axis=-1, keepdims=True))


LIE_CASES = {
    "so3_exp": lambda L: (lambda phi: L.so3_exp(phi), [lie_inputs(0, 3)]),
    "so3_log": lambda L: (lambda q: L.so3_log(q), [unit_quats(1)]),
    "se3_exp": lambda L: (lambda xi: L.se3_exp(xi), [lie_inputs(2, 6)]),
    "se3_log": lambda L: (lambda tq: L.se3_log(tq),
                          [np.concatenate([lie_inputs(3, 3), unit_quats(4)], -1)]),
    "se3_compose": lambda L: (lambda a, b: L.se3_compose(a, b),
                              [np.concatenate([lie_inputs(5, 3), unit_quats(6)], -1),
                               np.concatenate([lie_inputs(7, 3), unit_quats(8)], -1)]),
    "se3_inverse": lambda L: (lambda a: L.se3_inverse(a),
                              [np.concatenate([lie_inputs(9, 3), unit_quats(10)], -1)]),
    "se3_apply": lambda L: (lambda a, p: L.se3_apply(a, p),
                            [np.concatenate([lie_inputs(11, 3), unit_quats(12)], -1),
                             lie_inputs(13, 3)]),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    """Values to 2e-6 and finite gradients to 1e-5 relative, the identity
    and near-identity rows included."""
    jfn, inputs = LIE_CASES[name](jlie)
    pfn, _ = LIE_CASES[name](plie)
    assert_pair(both_grads(jfn, pfn, inputs), atol=2e-6)


def spline_knots(seed, n=10, k=6):
    """Knot tracks with consecutive rotations less than a half turn apart."""
    rng = np.random.default_rng(seed)
    xyz = f32(np.cumsum(rng.normal(size=(n, k, 3)) * 0.3, axis=1))
    steps = rng.normal(size=(n, k, 3)) * 0.4
    q = np.asarray(jlie.so3_exp(jnp.asarray(f32(np.cumsum(steps, axis=1)))))
    return xyz, f32(q)


@pytest.mark.parametrize("t", ["0", "0.37", "1", "per_point"])
@pytest.mark.parametrize("degree", [3, 1])
def test_spline_eval_matches_jax(t, degree):
    """spline_eval (translation and rotation) and spline_eval_vec at a
    shared time, at the range's ends, and at one time per point: values
    to 2e-6, gradients w.r.t. the knots to 1e-5 relative."""
    kx, kq = spline_knots(3)
    tt = (f32(np.random.default_rng(4).uniform(-0.1, 1.1, kx.shape[0])) if t == "per_point"
          else np.float32(float(t)))

    def fn(S):
        def f(x, q):
            return S.spline_eval(x, q, tt, degree) + (S.spline_eval_vec(x, tt, degree),)
        return f

    assert_pair(both_grads(fn(jspline), fn(pspline), [kx, kq]), atol=2e-6)


# ---------------------------------------------------------------------------
# models/deformation.py
# ---------------------------------------------------------------------------

SMALL_DEF = dict(grid_resolution=(4, 5, 6, 3), multires=(1, 2), net_width=8, grid_out_dim=4,
                 defor_depth=2, use_res=False, no_do=False)


def jax_deformation(seed=0):
    cfg = jdef.DeformationConfig(**SMALL_DEF)
    params = jdef.init_deformation_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params


def test_deformation_init_shapes_match_jax():
    """The port's own init has the JAX tree's leaves, shapes and constant
    parts (time planes at 1, zero biases; zero heads with use_res)."""
    for use_res in (False, True):
        jcfg = jdef.DeformationConfig(**dict(SMALL_DEF, use_res=use_res))
        want = flatten_tree(jdef.init_deformation_params(jax.random.PRNGKey(0), jcfg))
        got = pdef.init_deformation_params(pdef.DeformationConfig(**dict(SMALL_DEF,
                                                                        use_res=use_res)),
                                           torch.Generator().manual_seed(0))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            if k.endswith("/b") or (k.startswith("head") and use_res):
                assert not got[k].any(), k
        for s in range(2):
            for p in (2, 4, 5):  # the planes with the time axis
                assert torch.equal(got[f"grids/{s}/{p}"], torch.ones_like(got[f"grids/{s}/{p}"]))


def test_deformation_apply_matches_jax():
    """deformation_apply (every head on) on points inside and outside the
    bounds: the four outputs to 1e-5, gradients w.r.t. the points, the raw
    parameters and every plane and MLP weight to 1e-5 relative."""
    jcfg, jparams = jax_deformation()
    pcfg = pdef.DeformationConfig(**SMALL_DEF)
    flat = {k: f32(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    names = sorted(flat)
    rng = np.random.default_rng(5)
    n = 40
    xyz = f32(rng.uniform(-1.3, 1.3, (n, 3)))
    scaling, rotation = f32(rng.normal(size=(n, 3))), f32(rng.normal(size=(n, 4)))
    opacity, t = f32(rng.normal(size=(n, 1))), f32(rng.uniform(-1, 1, n))

    def jfn(x, s, r, o, *leaves):
        tree = unflatten_tree(dict(zip(names, leaves)))
        return jdef.deformation_apply(tree, jcfg, x, s, r, o, jnp.asarray(t))

    def pfn(x, s, r, o, *leaves):
        return pdef.deformation_apply(dict(zip(names, leaves)), pcfg, x, s, r, o,
                                      torch.tensor(t))

    assert_pair(both_grads(jfn, pfn, [xyz, scaling, rotation, opacity]
                           + [flat[k] for k in names]), atol=1e-5)


def test_grid_sample_matches_torch_grid_sample():
    """The formula agrees with F.grid_sample (bilinear, align_corners,
    border) inside the plane, so the choice between them is free there."""
    rng = np.random.default_rng(6)
    plane = torch.tensor(f32(rng.normal(size=(3, 5, 7))))
    coords = torch.tensor(f32(rng.uniform(-0.99, 0.99, (20, 2))))
    want = torch.nn.functional.grid_sample(plane[None], coords[None, :, None, :],
                                           align_corners=True, padding_mode="border")
    np.testing.assert_allclose(pdef._grid_sample_2d(plane, coords).numpy(),
                               want[0, :, :, 0].T.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# models/spacetime.py: the timed evaluation
# ---------------------------------------------------------------------------

MODES = {
    "polynomial": dict(enable_spacetime=True, num_frames=4),
    "per_frame": dict(enable_spacetime=False, enable_dynamic=True, num_frames=4),
    "deformation": dict(enable_spacetime=True, enable_deformation=True, num_frames=4),
    "spline": dict(enable_spacetime=True, enable_dynamic=True, use_spline=True, num_frames=5),
}
TEMPORAL_SHAPES = {"motion": (9,), "omega": (4,), "trbf_center": (1,), "trbf_scale": (1,)}


def random_spacetime_params(seed, n, num_frames, sh_rest=0):
    rng = np.random.default_rng(seed)
    p = dict(
        xyz=rng.normal(size=(n, 3)) * 0.5,
        features_dc=rng.normal(size=(n, 1, 3)),
        features_rest=rng.normal(size=(n, sh_rest, 3)) * 0.1,
        scaling=np.log(rng.uniform(0.02, 0.1, (n, 3))),
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)),
        motion=rng.normal(size=(n, 9)) * 0.3,
        omega=rng.normal(size=(n, 4)) * 0.3,
        trbf_center=rng.uniform(0, 1, (n, 1)),
        trbf_scale=rng.uniform(0.05, 0.2, (n, 1)),
        delta_xyz=rng.normal(size=(n, num_frames, 3)) * 0.1,
        delta_rot=rng.normal(size=(n, num_frames, 4)) * 0.1,
    )
    return {k: f32(v) for k, v in p.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_get_timed_all_matches_jax(mode):
    """The five activated outputs at t = 0.3, frame 2, to 2e-6 (values of
    order 1), and the gradients w.r.t. every parameter (the deformation
    network's too) to 1e-5 relative."""
    cfg_kw = dict(MODES[mode], capacity=64)
    jcfg, pcfg = jst.SpacetimeConfig(**cfg_kw), pst.SpacetimeConfig(**cfg_kw)
    params = random_spacetime_params(7, 64, cfg_kw["num_frames"])
    names = sorted(params)
    def_names, def_leaves, jdcfg, pdcfg = [], [], None, None
    if cfg_kw.get("enable_deformation"):
        jdcfg, jdparams = jax_deformation(1)
        pdcfg = pdef.DeformationConfig(**SMALL_DEF)
        flat = flatten_tree(jax.device_get(jdparams))
        def_names = sorted(flat)
        def_leaves = [f32(flat[k]) for k in def_names]
    n_p = len(names)

    def jfn(*leaves):
        p = jst.SpacetimeParams(**dict(zip(names, leaves[:n_p])))
        dp = unflatten_tree(dict(zip(def_names, leaves[n_p:]))) if def_names else None
        return tuple(jst.get_timed_all(p, jcfg, np.float32(0.3), 2, dp, jdcfg))

    def pfn(*leaves):
        p = pst.SpacetimeParams(**dict(zip(names, leaves[:n_p])))
        dp = dict(zip(def_names, leaves[n_p:])) if def_names else None
        return tuple(pst.get_timed_all(p, pcfg, np.float32(0.3), 2, dp, pdcfg))

    assert_pair(both_grads(jfn, pfn, [params[k] for k in names] + def_leaves), atol=2e-6)


def test_dynamic_mode_needs_frame_idx():
    cfg = pst.SpacetimeConfig(**MODES["per_frame"])
    p = pst.SpacetimeParams(**{k: torch.tensor(v) for k, v in
                               random_spacetime_params(0, 8, 4).items()})
    with pytest.raises(ValueError, match="frame_idx"):
        pst.get_motion(p, cfg, torch.zeros(8, 1), None)
    with pytest.raises(ValueError, match="frame_idx"):
        pst.get_omega(p, cfg, torch.zeros(8, 1), None)


def test_field_init_and_lrs_match_jax():
    """init_state (the temporal rows zero, trbf_scale at trbfslinit) and
    the per-field learning rates at three steps, equal to the JAX field's."""
    cfg = dict(enable_spacetime=True, enable_dynamic=True, num_frames=4, init_num_pts=32,
               capacity=64, move_lr=[0, 3.5, 0.1, 100], trbfs_lr=0.03, spatial_lr_scale=2.0)
    jfield = jst.SpacetimeGaussianField(jst.SpacetimeConfig(**cfg))
    pfield = pst.SpacetimeGaussianField(pst.SpacetimeConfig(**cfg), device="cpu")
    want, got = jax.device_get(jfield.init_state(0)), pfield.init_state(0)
    assert isinstance(got.params, pst.SpacetimeParams)
    for k in pst.SpacetimeParams.FIELDS:
        w = getattr(want.params, k)
        if w is None:
            assert getattr(got.params, k) is None, k
        else:
            # the scales come from 3-NN distances: to 1e-6 as the k-NN sums round
            np.testing.assert_allclose(getattr(got.params, k).numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6 if k == "scaling" else 0, err_msg=k)
            assert not got.adam.mu[k].any()
    for step in (0, 50, 100):
        jl = jfield.lr_tree(step)
        for k, v in pfield.lr_tree(step).items():
            assert v == float(np.asarray(getattr(jl, k))), (step, k)


# ---------------------------------------------------------------------------
# Structural ops of a spacetime field
# ---------------------------------------------------------------------------

CAP = 256


def make_spacetime_states(seed, n_alive=150):
    rng = np.random.default_rng(seed)
    alive = np.zeros(CAP, bool)
    alive[rng.choice(CAP, n_alive, replace=False)] = True
    p = random_spacetime_params(seed, CAP, 4, sh_rest=3)
    p["scaling"] = f32(np.log(rng.uniform(0.003, 0.025, (CAP, 3))))
    p["opacity"] = f32(rng.normal(size=(CAP, 1)) * 3.0 - 2.0)
    mu = random_spacetime_params(seed + 1, CAP, 4, sh_rest=3)
    nu = {k: np.abs(v) for k, v in random_spacetime_params(seed + 2, CAP, 4, sh_rest=3).items()}
    denom = rng.integers(0, 5, CAP).astype(np.float32)

    def tree(d):
        return jst.SpacetimeParams(**{k: jnp.asarray(v) for k, v in d.items()})

    jstate = jgf.GaussianState(
        params=tree(p), adam=joptim.AdamState(mu=tree(mu), nu=tree(nu), count=jnp.int32(5)),
        alive=jnp.asarray(alive), max_radii2d=jnp.asarray(f32(rng.uniform(0, 40, CAP))),
        xyz_grad_accum=jnp.asarray(f32(rng.uniform(0, 0.03, CAP) * denom)),
        denom=jnp.asarray(denom))
    return jstate, gaussian_state_from_numpy(jax.device_get(jstate), device="cpu")


def assert_spacetime_state_matches(got, want):
    """alive exact; every field (the temporal ones included) to 1e-6;
    moments and statistics exact; the params type kept."""
    assert isinstance(got.params, pst.SpacetimeParams)
    want = jax.device_get(want)
    got = to_numpy(got)
    np.testing.assert_array_equal(got["alive"], np.asarray(want.alive))
    for k in pst.SpacetimeParams.FIELDS:
        if k == "normal":
            continue
        np.testing.assert_allclose(got["params"][k], np.asarray(getattr(want.params, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(got["adam"][m][k],
                                          np.asarray(getattr(getattr(want.adam, m), k)), k)
    for k in pgf.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), k)


@pytest.mark.parametrize("split_thresh", [0.02, 0.0])
def test_spacetime_densify_matches_jax(split_thresh):
    """Clone + split of a field with every temporal field: the children
    take the parent's temporal rows, and both split children the JAX
    package's uniform trbf_center draw (its third key)."""
    jstate, pstate = make_spacetime_states(11)
    key = jax.random.PRNGKey(11)
    want = jgf.densify_op(jstate, key, jnp.float32(0.004), jnp.float32(split_thresh))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(jax.random.normal(k, (CAP, 3)))) for k in (k1, k2))
    draws += (torch.as_tensor(np.array(jax.random.uniform(k3, (CAP, 1)))),)
    got = pgf.densify_op(pstate, float(np.float32(0.004)), float(np.float32(split_thresh)),
                         draws=draws)
    assert got.n_alive > pstate.n_alive
    assert_spacetime_state_matches(got, want)


def test_spacetime_prune_and_cap_prune_match_jax():
    jstate, pstate = make_spacetime_states(12)
    want = jgf.prune_op(jstate, jnp.float32(0.1), prune_big_points=True)
    assert_spacetime_state_matches(pgf.prune_op(pstate, float(np.float32(0.1)), True), want)
    key = jax.random.PRNGKey(12)
    want = jgf.cap_prune_op(jstate, key, jnp.int32(90))
    got = pgf.cap_prune_op(pstate, 90, draws=torch.as_tensor(np.array(
        jax.random.uniform(key, (CAP,)))))
    assert got.n_alive == 90
    assert_spacetime_state_matches(got, want)


def test_temporal_ply_bytes_match_jax(tmp_path):
    """The temporal PLY of one field in both packages: equal bytes, the
    sidecar's columns equal, and load_temporal_ply gives back the alive
    rows of every temporal field."""
    jstate, pstate = make_spacetime_states(13)
    cfg = dict(enable_spacetime=True, enable_dynamic=True, num_frames=4, capacity=CAP,
               sh_degree=1)
    jst.SpacetimeGaussianField(jst.SpacetimeConfig(**cfg)).save_ply(
        jstate, str(tmp_path / "j.ply"), sidecar=True)
    pfield = pst.SpacetimeGaussianField(pst.SpacetimeConfig(**cfg), device="cpu")
    pfield.save_ply(pstate, str(tmp_path / "p.ply"), sidecar=True)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    side_j = pfield.load_extra(str(tmp_path / "j.ply.temporal.npz"))
    side_p = pfield.load_extra(str(tmp_path / "p.ply.temporal.npz"))
    assert list(side_p) == list(side_j)
    for k in side_j:
        np.testing.assert_array_equal(side_p[k], side_j[k])
    back = pfield.load_temporal_ply(str(tmp_path / "p.ply"))
    alive = pstate.alive
    for k in pst.TEMPORAL_FIELDS:
        np.testing.assert_array_equal(back[k], getattr(pstate.params, k)[alive].numpy(), k)


# ---------------------------------------------------------------------------
# data/temporal_image.py
# ---------------------------------------------------------------------------

def temporal_data_cfg(root=None):
    overrides = ["data.height=32", "data.width=32", "data.random_camera.height=16",
                 "data.random_camera.width=16", "data.video_length=5", "data.num_frames=3",
                 "data.random_camera.n_val_views=3", "data.random_camera.n_test_views=4",
                 "data.random_camera.eval_height=16", "data.random_camera.eval_width=16"]
    if root is not None:
        overrides.append(f"data.video_frames_dir={root}")
    name = "gs4d_motion.yaml"
    return (jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{name}", overrides).data,
            load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{name}", overrides).data)


def write_frames(root, n=5, size=40):
    rng = np.random.default_rng(14)
    for i in range(n):
        rgba = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
        rgba[..., 3] = np.where(rng.uniform(size=(size, size)) > 0.3, 255, 0)
        name = f"{i:03}_rgba.png" if i % 2 == 0 else f"{i}.png"
        Image.fromarray(rgba, "RGBA").save(root / name)


def assert_same_batch(got, want, where):
    """Equal keys; nested dicts recursively; ints, strings and None
    exactly, arrays to 1e-6."""
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            assert_same_batch(got[k], w, f"{where}/{k}")
        elif w is None or isinstance(w, (int, str)):
            assert got[k] == w, f"{where}/{k}"
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=f"{where}/{k}")


@pytest.mark.parametrize("source", ["synthetic", "frames"])
def test_temporal_batches_match_jax(source, tmp_path):
    """Three training batches of one seed (the frame subset, the frames,
    the cameras repeated per frame, the random views with their timestamps
    and frame indices) and the eval views with their times, equal in both
    packages; the frames from a directory of RGBA PNGs (both file names)
    or the synthetic moving square."""
    if source == "frames":
        write_frames(tmp_path)
    jcfg, pcfg = temporal_data_cfg(tmp_path if source == "frames" else None)
    jd = jtd.TemporalImageDataModule(jcfg, seed=3)
    pd = ptd.TemporalImageDataModule(pcfg, seed=3)
    np.testing.assert_allclose(pd.rgbs, jd.rgbs, rtol=0, atol=1e-6)
    for step in range(3):
        jb, pb = jd.train_batch(step), pd.train_batch(step)
        assert pb["rgb"].shape == (3, 32, 32, 3) and pb["random_camera"]["c2w"].shape[0] == 6
        assert_same_batch(pb, jb, f"step {step}")
    for split in ("val_views", "test_views"):
        for jv, pv in zip(getattr(jd, split)(), getattr(pd, split)()):
            assert_same_batch(pv, jv, split)


def test_temporal_resolution_milestones():
    """Both packages keep the first size for the whole run: the batches on
    either side of a resolution milestone (its frames, rays and cameras)
    are equal and at the first size."""
    jcfg, pcfg = temporal_data_cfg()
    sizes = dict(height=[16, 32], width=[16, 32], resolution_milestones=[2])
    jd = jtd.TemporalImageDataModule(dict(jcfg, **sizes), seed=0)
    pd = ptd.TemporalImageDataModule(dict(pcfg, **sizes), seed=0)
    for step in (1, 2, 3):
        jb, pb = jd.train_batch(step), pd.train_batch(step)
        assert pb["rgb"].shape[1:3] == (16, 16) and pb["rays_d"].shape[1:3] == (16, 16)
        assert (pb["height"], pb["width"]) == (16, 16)
        assert_same_batch(pb, jb, f"step {step}")


# ---------------------------------------------------------------------------
# renderers/spacetime.py
# ---------------------------------------------------------------------------

SCENE = ["data.height=32", "data.width=32", "data.random_camera.height=32",
         "data.random_camera.width=32", "data.random_camera.batch_size=1",
         "data.video_length=3", "data.num_frames=3", "system.geometry.num_frames=4",
         "system.geometry.init_num_pts=200", "system.geometry.capacity=320",
         "system.geometry.opacity_init=0.5", "system.renderer.tile_size=16",
         "system.renderer.max_pairs=65536", "system.renderer.batched=false",
         "system.renderer.adaptive_max_pairs=false"]
RENDER_KEYS = ("comp_rgb", "comp_depth", "comp_mask")


@pytest.mark.parametrize("config", ["gs4d_motion", "gs4d"])
def test_spacetime_renderer_matches_jax(config):
    """The three reference frames of a training batch through the spacetime
    renderer, polynomial motion (gs4d_motion) and spline with per-frame
    deltas (gs4d), on a field whose temporal rows are random: rgb, depth
    and mask to 2e-5, gradients w.r.t. every field over the alive rows to
    1e-4 relative."""
    jcfg = jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{config}.yaml", SCENE)
    pcfg = load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{config}.yaml", SCENE)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    init = jax.device_get(jsys.init_state(0).gauss)
    rnd = random_spacetime_params(15, 320, 4)
    # anisotropic scales: an isotropic Gaussian's rotation gradient is
    # rounding (ROADMAP section 3)
    random_rows = pst.TEMPORAL_FIELDS + ("scaling", "rotation")
    params = {k: (rnd[k] if k in random_rows else np.asarray(v))
              for k, v in vars(init.params).items() if v is not None}
    jgauss = init.replace(params=jst.SpacetimeParams(**{k: jnp.asarray(v)
                                                        for k, v in params.items()}))
    pgauss = gaussian_state_from_numpy(jax.device_get(jgauss), "cpu")
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)
    rng = np.random.default_rng(16)
    weights = {k: f32(rng.normal(size=(3, 32, 32, 3 if k == "comp_rgb" else 1)))
               for k in RENDER_KEYS}
    jb = dict(to_device_batch(batch), height=32, width=32)

    def jloss(gp):
        out = jsys.renderer.batch_forward(jgauss.replace(params=gp), jb, training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in RENDER_KEYS), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jgauss.params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pgauss.params.as_dict().items()}
    gs = dataclasses.replace(pgauss, params=pst.SpacetimeParams(**leaves))
    pout = psys.renderer.batch_forward(gs, batch, training=False)
    sum(torch.sum(pout[k] * torch.tensor(weights[k])) for k in RENDER_KEYS).backward()
    for k in RENDER_KEYS:
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=2e-5, err_msg=k)
    assert int(pout["n_dropped"].sum()) == 0
    alive = np.asarray(init.alive)
    moved = ["xyz", "features_dc", "scaling", "rotation", "opacity"]
    moved += ["motion", "omega"] if config == "gs4d_motion" else ["delta_xyz", "delta_rot"]
    for k in moved:
        want = np.asarray(getattr(jg, k))[alive]
        assert np.abs(want).max() > 0, k
        assert rel_l2(leaves[k].grad.numpy()[alive], want) <= 1e-4, k


# ---------------------------------------------------------------------------
# ops/arap.py, ops/sugar_reg.py
# ---------------------------------------------------------------------------

def test_arap_energy_knn_matches_jax():
    """The lite ARAP on a k-NN table with a mask (some rows dead), over the
    whole table and over the live rows alone: the energy to 1e-5 relative
    and its gradient w.r.t. the deformed points to 1e-5 relative; the
    fitted rotations are proper (det 1)."""
    rng = np.random.default_rng(17)
    rest = f32(rng.normal(size=(48, 3)))
    rot = np.asarray(jlie.so3_exp(jnp.asarray(f32(rng.normal(size=(48, 3)) * 0.2))))
    from threestudio_3dgs_tpu.ops import quaternion as jq
    deformed = f32(np.asarray(jq.apply(jnp.asarray(rot), jnp.asarray(rest)))
                   + rng.normal(size=(48, 3)) * 0.05)
    _, idx = pknn(torch.tensor(rest), torch.tensor(rest), k=6, exclude_self=True)
    alive = f32(rng.uniform(size=48) > 0.2)
    mask = f32(alive[:, None] * alive[idx.numpy()])
    jout = jax.value_and_grad(lambda d: jarap.arap_energy_knn(
        jnp.asarray(rest), d, jnp.asarray(idx.numpy()), jnp.asarray(mask)))(jnp.asarray(deformed))
    x = torch.tensor(deformed, requires_grad=True)
    e = parap.arap_energy_knn(torch.tensor(rest), x, idx, torch.tensor(mask))
    e.backward()
    assert float(e.detach()) == pytest.approx(float(jout[0]), rel=1e-5)
    assert rel_l2(x.grad.numpy(), np.asarray(jout[1])) <= 1e-5
    # over the live rows alone, as the 4D system sums it: the same energy
    rows = torch.nonzero(torch.tensor(alive > 0)).squeeze(1)
    x_rows = torch.tensor(deformed, requires_grad=True)
    e_rows = parap.arap_energy_knn(torch.tensor(rest), x_rows, idx[rows],
                                   torch.tensor(mask)[rows], rows=rows)
    e_rows.backward()
    assert float(e_rows.detach()) == pytest.approx(float(jout[0]), rel=1e-5)
    assert rel_l2(x_rows.grad.numpy(), np.asarray(jout[1])) <= 1e-5
    e_rest = torch.tensor(rest)[:, None] - torch.tensor(rest)[idx]
    e_def = torch.tensor(deformed)[:, None] - torch.tensor(deformed)[idx]
    r = parap.fit_rotations(e_rest, e_def, torch.tensor(mask))
    np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0, atol=1e-5)


def test_arap_energy_mesh_matches_jax():
    """One-ring tables, cotangent weights and the ARAP energy with the
    weights on a small grid mesh: tables equal, weights to 1e-5, energy to
    1e-5 relative."""
    g = 5
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    verts = np.stack([ii.ravel(), jj.ravel(), np.zeros(g * g)], -1).astype(np.float32)
    verts[:, 2] = np.random.default_rng(18).normal(size=g * g) * 0.1
    faces = []
    for a in range(g - 1):
        for b in range(g - 1):
            v = a * g + b
            faces += [[v, v + 1, v + g], [v + 1, v + g + 1, v + g]]
    faces = np.asarray(faces, np.int32)
    jidx, jmask = jarap.build_one_ring(faces, g * g, max_degree=4)
    pidx, pmask = parap.build_one_ring(faces, g * g, max_degree=4)
    np.testing.assert_array_equal(pidx, jidx)
    np.testing.assert_array_equal(pmask, jmask)
    jw = np.asarray(jarap.cotangent_weights(jnp.asarray(verts), jnp.asarray(faces),
                                            jnp.asarray(jidx), jnp.asarray(jmask)))
    pw = parap.cotangent_weights(torch.tensor(verts), torch.tensor(faces), torch.tensor(pidx),
                                 torch.tensor(pmask))
    np.testing.assert_allclose(pw.numpy(), jw, rtol=0, atol=1e-5)
    deformed = f32(verts + np.random.default_rng(19).normal(size=verts.shape) * 0.05)
    want = float(jarap.arap_energy(jnp.asarray(verts), jnp.asarray(deformed), jnp.asarray(jidx),
                                   jnp.asarray(jmask), jnp.asarray(jw)))
    got = float(parap.arap_energy(torch.tensor(verts), torch.tensor(deformed),
                                  torch.tensor(pidx), torch.tensor(pmask), pw))
    assert got == pytest.approx(want, rel=1e-5)


def gaussian_cloud(seed, n=96):
    rng = np.random.default_rng(seed)
    alive = rng.uniform(size=n) > 0.15
    return dict(means=f32(rng.normal(size=(n, 3)) * 0.4),
                scales=f32(rng.uniform(0.03, 0.12, (n, 3))),
                quats=f32(rng.normal(size=(n, 4))),
                opacities=f32(rng.uniform(0.2, 0.9, n)),
                alive=alive)


def sugar_draws(key, n_samples, n):
    """The JAX sampler's draws for ``key``: the Gumbel noise of its
    categorical and its normals."""
    k1, k2 = jax.random.split(key)
    return {"gumbel": np.array(jax.random.gumbel(k1, (n_samples, n))),
            "normal": np.array(jax.random.normal(k2, (n_samples, 3)))}


def sugar_loss_pair(name, cloud, key, knn_idx, n_samples):
    fields = ("means", "scales", "quats", "opacities")
    alive = cloud["alive"]
    cam_args = (f32(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.5], [0, 0, 0, 1]])),
                0.9, 0.9, 24, 24)
    depth = f32(np.random.default_rng(20).uniform(2.0, 3.0, (24, 24)))

    def jfn(*xs):
        g = dict(zip(fields, xs), alive=jnp.asarray(alive))
        if name == "density":
            return jsugar.density_regulation_loss(key, g, jnp.asarray(knn_idx),
                                                  jcamera(*cam_args), jnp.asarray(depth),
                                                  n_samples)
        return jsugar.sdf_better_normal_loss(key, g, jnp.asarray(knn_idx), n_samples)

    draws = sugar_draws(key, n_samples, alive.shape[0])

    def pfn(*xs):
        g = dict(zip(fields, xs), alive=torch.tensor(alive))
        if name == "density":
            return psugar.density_regulation_loss(None, g, torch.tensor(knn_idx),
                                                  pcamera(*cam_args, device="cpu"),
                                                  torch.tensor(depth), n_samples, draws)
        return psugar.sdf_better_normal_loss(None, g, torch.tensor(knn_idx), n_samples,
                                             draws=draws)

    return both_grads(jfn, pfn, [cloud[k] for k in fields])


def test_sugar_sampler_matches_jax():
    """The volume-proportional samples from the JAX draws: the same source
    Gaussians (live ones only) and points to 1e-6."""
    cloud = gaussian_cloud(21)
    key = jax.random.PRNGKey(21)
    jpts, jidx = jsugar.sample_points_in_gaussians(
        key, *(jnp.asarray(cloud[k]) for k in ("means", "scales", "quats", "alive")), 200)
    ppts, pidx = psugar.sample_points_in_gaussians(
        None, *(torch.tensor(cloud[k]) for k in ("means", "scales", "quats", "alive")), 200,
        sugar_draws(key, 200, 96))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert cloud["alive"][pidx.numpy()].all()
    np.testing.assert_allclose(ppts.numpy(), np.asarray(jpts), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["density", "normal"])
def test_sugar_losses_match_jax(name):
    """density_regulation_loss (and beta) and sdf_better_normal_loss (the
    density gradient by autograd, kept in the graph) with the JAX draws:
    values to 1e-5, gradients w.r.t. means, scales, quats and opacities to
    1e-4 relative (second-order through the normal loss)."""
    cloud = gaussian_cloud(22)
    guarded = np.where(cloud["alive"][:, None], cloud["means"], 1e6)
    _, knn_idx = pknn(torch.tensor(f32(guarded)), torch.tensor(f32(guarded)), k=8)
    jouts, jgrads, pouts, pgrads = sugar_loss_pair(name, cloud, jax.random.PRNGKey(23),
                                                   knn_idx.numpy(), 128)
    assert pouts[0] > 0
    assert_pair((jouts, jgrads, pouts, pgrads), atol=1e-5, grad_rel=1e-4)


def test_registered_names():
    assert pfind("spacetime-gaussian-splatting") is pst.SpacetimeGaussianField
    assert issubclass(pfind("gaussian-splatting-dynamic"), pst.SpacetimeGaussianField)
    assert pfind("temporal-image-datamodule") is ptd.TemporalImageDataModule
    assert pfind("diff-gaussian-rasterizer-spacetime").temporal
    field = pfind("gaussian-splatting-dynamic")({"capacity": 8, "init_num_pts": 4},
                                                 device="cpu")
    assert field.cfg.enable_dynamic and not field.cfg.enable_spacetime
    state = SystemState(gauss=field.init_state(0))
    assert state.gauss.params.delta_xyz.shape == (8, 14, 3) and state.gauss.params.motion is None
