"""The port's field initialisations (threestudio_3dgs_tpu_torch.models.
gaussian_field.init_state with ``geometry_convert_from``) against the JAX
package's ``init_state`` on the CPU, one case per source: a checkpoint warm
start (each package's own checkpoint of the same trained-looking field), a
full 3DGS PLY, a plain vertex PLY (with colours, colours ignored, without
colours; the reference's axis permutation), and the ``shap-e:`` / ``lrm:``
prompt fallback; and the active SH degree each source starts at."""

import jax
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.models import ply_io as jply
from threestudio_3dgs_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint

from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.utils.ckpt import save_checkpoint

BASE = dict(init_num_pts=200, capacity=600, sh_degree=1, opacity_init=0.2)


def trained_field(seed=0):
    """A JAX field with every parameter, moment and statistic perturbed and
    some rows dead, as a trained checkpoint holds it."""
    state = jax.device_get(jgf.init_state(jgf.GaussianFieldConfig(**BASE), seed=seed))
    rng = np.random.default_rng(seed + 1)

    def noisy(a):
        return (np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32)).astype(np.float32)

    params = jax.tree_util.tree_map(noisy, state.params)
    alive = np.asarray(state.alive).copy()
    alive[rng.choice(200, 30, replace=False)] = False
    alive[250:260] = True
    return state.replace(
        params=params, alive=alive,
        adam=state.adam.replace(mu=jax.tree_util.tree_map(noisy, state.adam.mu),
                                nu=jax.tree_util.tree_map(noisy, state.adam.nu), count=17),
        max_radii2d=noisy(state.max_radii2d), xyz_grad_accum=noisy(state.xyz_grad_accum),
        denom=noisy(state.denom))


def assert_states_equal(got, want):
    """The port's initial state equals the JAX package's: params, alive,
    Adam (count 0, zero moments) and zero statistics."""
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for name in pgf.PARAM_FIELDS:
        w = getattr(want.params, name)
        if w is None:
            assert getattr(got.params, name) is None
            continue
        # the k-NN distances of the point-cloud sources go through an f32
        # matrix product in both packages
        np.testing.assert_allclose(getattr(got.params, name).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got.adam.mu[name].numpy(),
                                      np.asarray(getattr(want.adam.mu, name)))
        np.testing.assert_array_equal(got.adam.nu[name].numpy(),
                                      np.asarray(getattr(want.adam.nu, name)))
        assert not got.adam.mu[name].any() and not got.adam.nu[name].any()
    assert got.adam.count == int(want.adam.count) == 0
    for name in pgf.STAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        assert not getattr(got, name).any()


def init_pair(src, seed=0, **kw):
    cfg = dict(BASE, geometry_convert_from=src, **kw)
    want = jax.device_get(jgf.init_state(jgf.GaussianFieldConfig(**cfg), seed=seed))
    got = pgf.init_state(pgf.GaussianFieldConfig(**cfg), seed=seed, device="cpu")
    degrees = (jgf.GaussianField(dict(cfg)).active_sh_degree,
               pgf.GaussianField(dict(cfg), device="cpu").active_sh_degree)
    return got, want, degrees


def test_checkpoint_warm_start_matches_jax(tmp_path):
    """The same field saved by each package in its own format: both warm
    starts give its params and alive rows exactly, at its capacity, with
    fresh Adam moments and zeroed statistics, and start at the config's SH
    degree."""
    field = trained_field()
    jpath, ppath = str(tmp_path / "jax.ckpt.npz"), str(tmp_path / "port.ckpt.npz")
    jax_save_checkpoint(jpath, field, 17)
    save_checkpoint(ppath, SystemState(gauss=gaussian_state_from_numpy(field, device="cpu")), 17)
    want = jax.device_get(jgf.init_state(jgf.GaussianFieldConfig(**dict(
        BASE, geometry_convert_from=jpath))))
    got = pgf.init_state(pgf.GaussianFieldConfig(**dict(BASE, geometry_convert_from=ppath)),
                         device="cpu")
    assert_states_equal(got, want)
    for name in pgf.PARAM_FIELDS:
        if getattr(field.params, name) is not None:
            np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                          np.asarray(getattr(field.params, name)))
    degrees = (jgf.GaussianField(dict(BASE, geometry_convert_from=jpath)).active_sh_degree,
               pgf.GaussianField(dict(BASE, geometry_convert_from=ppath),
                                 device="cpu").active_sh_degree)
    assert degrees == (1, 1)


def test_gaussian_ply_warm_start_matches_jax(tmp_path):
    """A 3DGS PLY of the field's alive rows (SH degree 1, written by the JAX
    package): both load every attribute into the first rows, equal, and
    start at the config's SH degree."""
    field = trained_field(seed=2)
    alive = np.asarray(field.alive)
    path = str(tmp_path / "field.ply")
    p = field.params
    jply.save_gaussian_ply(path, xyz=np.asarray(p.xyz)[alive],
                           features_dc=np.asarray(p.features_dc)[alive],
                           features_rest=np.asarray(p.features_rest)[alive],
                           opacity=np.asarray(p.opacity)[alive],
                           scaling=np.asarray(p.scaling)[alive],
                           rotation=np.asarray(p.rotation)[alive])
    got, want, degrees = init_pair(path)
    assert_states_equal(got, want)
    assert int(got.alive.sum()) == int(alive.sum()) and bool(got.alive[: int(alive.sum())].all())
    np.testing.assert_array_equal(got.params.features_rest[: int(alive.sum())].numpy(),
                                  np.asarray(p.features_rest)[alive])
    assert degrees == (1, 1)


def write_vertex_ply(path, n, colors, seed=0):
    rng = np.random.default_rng(seed)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    table = np.zeros(n, dtype=fields)
    for k in ("x", "y", "z"):
        table[k] = rng.normal(size=n).astype(np.float32) * 0.4
    if colors:
        for k in ("red", "green", "blue"):
            table[k] = rng.integers(0, 256, n)
    kinds = {"<f4": "float", "u1": "uchar"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {kinds[t]} {name}" for name, t in fields] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(table.tobytes())


@pytest.mark.parametrize("colors,position_only", [(True, False), (True, True), (False, False)],
                         ids=["colors", "colors_ignored", "no_colors"])
def test_vertex_ply_matches_jax(tmp_path, colors, position_only):
    """A plain point cloud with load_ply_only_vertex: the points through
    the reference's axis permutation, the k-NN scales, the colours / 255
    or (ignored or absent) the seeded random colours; SH degree 0."""
    path = str(tmp_path / "points.ply")
    write_vertex_ply(path, 150, colors)
    got, want, degrees = init_pair(path, seed=5, load_ply_only_vertex=True,
                                   load_vertex_only_position=position_only)
    assert_states_equal(got, want)
    assert int(got.alive.sum()) == 150
    assert degrees == (0, 0)


@pytest.mark.parametrize("src", ["shap-e:a hamburger", "lrm:a red chair"])
def test_prompt_fallback_matches_jax(src):
    """shap-e: / lrm: with no such guidance registered in either package:
    the random sphere drawn from CRC32(prompt) ^ seed, unlike the seed's
    own sphere; SH degree 0."""
    got, want, degrees = init_pair(src, seed=3)
    assert_states_equal(got, want)
    plain = pgf.init_state(pgf.GaussianFieldConfig(**BASE), seed=3, device="cpu")
    assert not torch.equal(got.params.xyz, plain.params.xyz)
    assert degrees == (0, 0)


def test_missing_and_unknown_sources(tmp_path):
    """A missing PLY raises FileNotFoundError in both; a source of no known
    kind raises in the port (the JAX package quietly takes the sphere)."""
    cfg = dict(BASE, geometry_convert_from=str(tmp_path / "none.ply"))
    with pytest.raises(FileNotFoundError):
        jgf.init_state(jgf.GaussianFieldConfig(**cfg))
    with pytest.raises(FileNotFoundError):
        pgf.init_state(pgf.GaussianFieldConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="geometry_convert_from"):
        pgf.init_state(pgf.GaussianFieldConfig(**dict(BASE, geometry_convert_from="mesh.obj")),
                       device="cpu")


@pytest.mark.parametrize("src, vertex_only, kind", [
    ("", False, "sphere"),
    ("shap-e:a red chair", False, "prompt"),
    ("lrm:a chair.ply", False, "prompt"),
    ("run/ckpts/last.ckpt.npz", False, "checkpoint"),
    ("run/last.ckpt", True, "checkpoint"),
    ("cloud.ply", False, "ply"),
    ("cloud.ply", True, "vertex_ply"),
])
def test_source_kind(src, vertex_only, kind):
    """One classification of ``geometry_convert_from`` drives both
    ``init_state`` and the starting SH degree: a prompt prefix wins over a
    file suffix, ``load_ply_only_vertex`` matters only for a PLY, and only
    a checkpoint or a full PLY starts at the config's degree."""
    cfg = pgf.GaussianFieldConfig(**dict(BASE, geometry_convert_from=src,
                                         load_ply_only_vertex=vertex_only))
    assert pgf.source_kind(cfg) == kind
    want_degree = BASE["sh_degree"] if kind in ("checkpoint", "ply") else 0
    assert pgf.GaussianField(cfg, device="cpu").active_sh_degree == want_degree
