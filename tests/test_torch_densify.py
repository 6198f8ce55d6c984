"""The port's structural field updates against the JAX package on the CPU:
clone / split / prune / cap-prune / opacity reset / SuGaR prune, the Adam
moment surgery, the interval gating of ``update_states``, and a training
run of both packages through two densify steps.

Every case starts from one seeded numpy state, built as a JAX
``GaussianState`` and carried to the port with ``models/convert.py``; the
random draws of the split children and the cap-prune are the JAX package's
own, fed to the port through its test-only ``draws`` keyword."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.models import optim as joptim
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models import optim as poptim
from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy, to_numpy
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.config import load_config

from test_torch_train import JAX_CONFIG, JAX_ONLY, OVERRIDES, PARAM_ATOL, PORT_CONFIG

CAP = 1024
SH_DEGREE = 1
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def make_states(seed, n_alive=600, cap=CAP):
    """A field of `cap` rows with `n_alive` alive rows scattered among dead
    ones, log-scales around the split threshold (0.02), opacities around
    the prune threshold, non-zero Adam moments and statistics (some rows
    never visible).  Returns (JAX state, port state)."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n_alive, replace=False)] = True
    k_rest = (SH_DEGREE + 1) ** 2 - 1

    def params():
        return dict(
            xyz=rng.normal(size=(cap, 3)) * 0.5,
            features_dc=rng.normal(size=(cap, 1, 3)),
            features_rest=rng.normal(size=(cap, k_rest, 3)) * 0.1,
            scaling=np.log(rng.uniform(0.003, 0.025, size=(cap, 3))),
            rotation=rng.normal(size=(cap, 4)),
            opacity=rng.normal(size=(cap, 1)) * 3.0 - 2.0,
        )

    def f32(tree):
        return {k: np.asarray(v, np.float32) for k, v in tree.items()}

    p, mu, nu = f32(params()), f32(params()), {k: np.abs(v) for k, v in f32(params()).items()}
    denom = rng.integers(0, 5, cap).astype(np.float32)
    accum = (rng.uniform(0.0, 0.03, cap) * denom).astype(np.float32)
    radii = rng.uniform(0.0, 40.0, cap).astype(np.float32)
    jstate = jgf.GaussianState(
        params=jgf.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        adam=joptim.AdamState(
            mu=jgf.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
            nu=jgf.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
            count=jnp.int32(7),
        ),
        alive=jnp.asarray(alive),
        max_radii2d=jnp.asarray(radii),
        xyz_grad_accum=jnp.asarray(accum),
        denom=jnp.asarray(denom),
    )
    return jstate, gaussian_state_from_numpy(jax.device_get(jstate), device="cpu")


def densify_draws(key, cap=CAP):
    """densify_op's two split-children normals for `key`."""
    k1, k2, _ = jax.random.split(key, 3)
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, (cap, 3)))) for k in (k1, k2))


def cap_prune_draws(key, cap=CAP):
    return torch.as_tensor(np.array(jax.random.uniform(key, (cap,))))


def assert_state_matches(got, want, before=None):
    """alive exact; params to 1e-6 absolute; Adam moments and count exact
    (zeroed rows exactly zero, the rest bit-equal); statistics exact."""
    want = jax.device_get(want)
    got = to_numpy(got)
    np.testing.assert_array_equal(got["alive"], np.asarray(want.alive))
    for k in FIELDS:
        np.testing.assert_allclose(got["params"][k], np.asarray(getattr(want.params, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(got["adam"][m][k],
                                          np.asarray(getattr(getattr(want.adam, m), k)),
                                          err_msg=f"{m}/{k}")
    assert got["adam"]["count"] == int(want.adam.count)
    for k in pgf.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
    if before is not None:  # the op left the state it was given untouched
        for k, v in to_numpy(before[1])["params"].items():
            np.testing.assert_array_equal(v, np.asarray(getattr(before[0].params, k)))


# ---------------------------------------------------------------------------
# Adam moment surgery
# ---------------------------------------------------------------------------


def test_zero_moments_at_matches_jax():
    """Rows out of range (CAP, 2 CAP) are dropped; duplicates are harmless;
    count is unchanged."""
    jstate, pstate = make_states(0)
    rows = np.array([3, 17, CAP, 17, 1000, 2 * CAP, 0], np.int64)
    want = joptim.zero_moments_at(jstate.adam, jnp.asarray(rows, jnp.int32))
    got = poptim.zero_moments_at(pstate.adam, torch.as_tensor(rows))
    for k in FIELDS:
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(getattr(got, m)[k].numpy(),
                                          np.asarray(getattr(getattr(want, m), k)))
    assert got.count == 7
    assert not got.mu["xyz"][[0, 3, 17, 1000]].any() and got.mu["xyz"][1].all()


def test_zero_moments_field_matches_jax():
    jstate, pstate = make_states(1)
    want = joptim.zero_moments_field(jstate.adam, "opacity")
    got = poptim.zero_moments_field(pstate.adam, "opacity")
    for k in FIELDS:
        np.testing.assert_array_equal(got.nu[k].numpy(), np.asarray(getattr(want.nu, k)))
    assert not got.mu["opacity"].any() and got.mu["xyz"].any()


# ---------------------------------------------------------------------------
# Structural ops, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("want_rows", ["some", "all"])
def test_free_slot_targets_matches_jax(want_rows):
    """Distinct free slots in ascending order by rank; CAP past the last
    free slot (with "all", more rows want a slot than are free)."""
    jstate, pstate = make_states(2)
    rng = np.random.default_rng(2)
    want = np.asarray(jstate.alive) & (rng.random(CAP) < (0.2 if want_rows == "some" else 1.0))
    expected = np.asarray(jgf._free_slot_targets(jstate.alive, jnp.asarray(want)))
    got = pgf._free_slot_targets(pstate.alive, torch.as_tensor(want)).numpy()
    np.testing.assert_array_equal(got, expected)
    assert (got[~want] == CAP).all()
    assert (got[want] == CAP).any() == (want_rows == "all")


@pytest.mark.parametrize("big_points", [False, True])
def test_prune_matches_jax(big_points):
    jstate, pstate = make_states(3)
    want = jgf.prune_op(jstate, jnp.float32(0.05), prune_big_points=big_points)
    got = pgf.prune_op(pstate, float(np.float32(0.05)), prune_big_points=big_points)
    assert 0 < got.n_alive < pstate.n_alive
    assert_state_matches(got, want)


def test_reset_opacity_matches_jax():
    jstate, pstate = make_states(4)
    want = jgf.reset_opacity_op(jstate)
    got = pgf.reset_opacity_op(pstate)
    assert_state_matches(got, want, before=(jstate, pstate))
    assert pstate.adam.mu["opacity"].any()  # the input's moments stay


def test_sugar_prune_matches_jax():
    jstate, pstate = make_states(5)
    want = jgf.sugar_prune_op(jstate, jnp.float32(0.5))
    got = pgf.sugar_prune_op(pstate, 0.5)
    assert 0 < got.n_alive < pstate.n_alive
    assert_state_matches(got, want)


def test_cap_prune_matches_jax():
    jstate, pstate = make_states(6)
    key = jax.random.PRNGKey(6)
    want = jgf.cap_prune_op(jstate, key, jnp.int32(250))
    got = pgf.cap_prune_op(pstate, 250, draws=cap_prune_draws(key))
    assert got.n_alive == 250
    assert_state_matches(got, want)


# (case, alive rows, grad threshold, split threshold): clones and splits
# together; clone only; split only; and more clones + splits than free
# slots, so the overflow is dropped
DENSIFY_CASES = [
    ("clone_and_split", 500, 0.004, 0.02),
    ("clone_only", 400, 0.004, 1e9),
    ("split_only", 400, 0.004, 0.0),
    ("overflow", 900, 0.0, 0.02),
]


@pytest.mark.parametrize("case,n_alive,grad_thresh,split_thresh", DENSIFY_CASES)
def test_densify_matches_jax(case, n_alive, grad_thresh, split_thresh):
    jstate, pstate = make_states(7, n_alive=n_alive)
    key = jax.random.PRNGKey(7)
    want = jgf.densify_op(jstate, key, jnp.float32(grad_thresh), jnp.float32(split_thresh))
    got = pgf.densify_op(pstate, float(np.float32(grad_thresh)), float(np.float32(split_thresh)),
                         draws=densify_draws(key))
    grown = got.n_alive - pstate.n_alive
    if case == "overflow":
        assert got.n_alive == CAP  # every free slot taken, the rest dropped
    else:
        assert 0 < grown < CAP - pstate.n_alive
    assert_state_matches(got, want, before=(jstate, pstate))
    # the zeroed moments: the new rows, and the split parents
    new_rows = got.alive & ~pstate.alive
    assert not got.adam.mu["xyz"][new_rows].any() and not got.adam.nu["scaling"][new_rows].any()


@pytest.mark.parametrize("sphere", [False, True])
def test_densify_sphere_matches_jax(sphere):
    """The isotropic (sphere) scaling takes the mean log-scale."""
    jstate, pstate = make_states(8)
    key = jax.random.PRNGKey(8)
    want = jgf.densify_op(jstate, key, jnp.float32(0.004), jnp.float32(0.02), sphere=sphere)
    got = pgf.densify_op(pstate, float(np.float32(0.004)), float(np.float32(0.02)),
                         sphere=sphere, draws=densify_draws(key))
    assert_state_matches(got, want)


# ---------------------------------------------------------------------------
# update_states: the gating and the order of the ops
# ---------------------------------------------------------------------------

GATING = dict(densify_from_iter=10, densify_until_iter=100, densification_interval=10,
              prune_from_iter=10, prune_until_iter=100, prune_interval=10,
              opacity_reset_interval=40, densify_grad_threshold=0.004, split_thresh=0.02,
              min_opac_prune=0.05, capacity=CAP, sh_degree=SH_DEGREE)

# (case, config overrides, iteration, changed): the SuGaR prune alone; the
# cap check returns before anything else runs; prune then reset (densify
# not due); prune then densify; a step where nothing is due
UPDATE_CASES = [
    ("sugar", dict(sugar_prune_at=33, sugar_prune_threshold=0.4), 33, True),
    ("cap", dict(max_num=450), 30, True),
    ("prune_reset", dict(densification_interval=7), 40, True),
    ("prune_densify", {}, 30, True),
    ("densify_only", dict(prune_from_iter=50), 30, True),
    ("idle", {}, 35, False),
]


@pytest.mark.parametrize("case,overrides,iteration,changed", UPDATE_CASES)
def test_update_states_matches_jax(case, overrides, iteration, changed):
    cfg = dict(GATING, **overrides)
    jstate, pstate = make_states(9)
    key = jax.random.PRNGKey(9)
    want, want_changed = jgf.GaussianField(jgf.GaussianFieldConfig(**cfg)).update_states(
        jstate, iteration, key)
    _, sub = jax.random.split(key)  # update_states hands its ops one split
    draws = cap_prune_draws(sub) if case == "cap" else densify_draws(sub)
    field = pgf.GaussianField(pgf.GaussianFieldConfig(**cfg), device="cpu")
    got, got_changed = field.update_states(pstate, iteration, draws=draws)
    assert got_changed == want_changed == changed
    assert_state_matches(got, want)
    if case == "cap":
        assert got.n_alive == 450
    elif case == "idle":
        assert got is pstate


# ---------------------------------------------------------------------------
# Both packages trained through two densify steps
# ---------------------------------------------------------------------------

DENSIFY_STEPS = 12
# clone only (split_thresh huge) and every alive row hot (threshold 0), so
# no draw is made and the alive sets must agree exactly: 256 -> 512 -> 1024
# at iterations 4 and 8.  A low initial opacity keeps the stacks of
# identical clones clear of the blend's transmittance cut-off, where a copy
# is blended in one package and not in the other.
DENSIFY_OVERRIDES = [
    f"trainer.max_steps={DENSIFY_STEPS}",
    "system.geometry.densify_from_iter=2",
    "system.geometry.densification_interval=4",
    "system.geometry.densify_grad_threshold=0.0",
    "system.geometry.split_thresh=1000000000.0",
    "system.geometry.opacity_init=0.05",
]
# free slots are taken in ascending order: the second densify fills rows
# 512-1023, which then take 3 Adam steps from zeroed moments
NEWEST = slice(512, 1024)
# the most a field's learning rate reaches in the YAML's schedule
MAX_LR = {"xyz": 0.001, "features_dc": 0.01, "scaling": 0.005, "rotation": 0.005, "opacity": 0.05}


@pytest.fixture(scope="module")
def trained_densify(tmp_path_factory):
    root = tmp_path_factory.mktemp("densify")
    overrides = [o for o in OVERRIDES if not o.startswith("trainer.max_steps")] + DENSIFY_OVERRIDES
    jt = JaxTrainer(jax_load_config(
        JAX_CONFIG, overrides + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    jt.state = jt.system.init_state(jt.cfg.seed)
    init = jax.device_get(jt.state.gauss)
    jt.fit()
    pt = Trainer(load_config(PORT_CONFIG, overrides + [f"exp_root_dir={root / 'port'}"]),
                 device="cpu")
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
    pt.fit()
    return jt, pt, init


def test_densify_training_gauss_num_matches_jax(trained_densify):
    jt, pt, _ = trained_densify
    want = [row["gauss_num"] for row in jt.metrics_log]
    got = [row["gauss_num"] for row in pt.metrics_log]
    assert got == want
    # the logged row of iteration i is taken before that step's update
    assert got[4] == 256 and got[5] == got[8] == 512 and got[9] == got[-1] == 1024, got
    np.testing.assert_array_equal(pt.state.gauss.alive.numpy(),
                                  np.asarray(jt.state.gauss.alive))


@pytest.mark.parametrize("field", sorted(PARAM_ATOL))
def test_densify_training_params_match_jax(trained_densify, field):
    """The rows alive before the second densify to test_torch_train's
    tolerances.  The newest rows took 3 Adam steps from zeroed moments,
    where m_hat / sqrt(v_hat) is about +-0.5 whatever the gradient's size:
    a gradient at rounding level moves such a row by up to ~0.7 lr per step
    in either package, so there the bulk (90% of the elements) is held to
    the same tolerances and every element to 4 lr."""
    jt, pt, init = trained_densify
    want = np.asarray(getattr(jax.device_get(jt.state.gauss.params), field))
    got = getattr(pt.state.gauss.params, field).numpy()
    older = slice(0, NEWEST.start)
    np.testing.assert_allclose(got[older], want[older], rtol=0, atol=PARAM_ATOL[field])
    moved = np.abs(want[:256] - np.asarray(getattr(init.params, field))[:256]).max()
    assert moved > 5 * PARAM_ATOL[field], moved
    new_diff = np.abs(got[NEWEST] - want[NEWEST])
    assert (new_diff <= PARAM_ATOL[field]).mean() >= 0.9
    assert new_diff.max() <= 4 * MAX_LR[field]


def test_densify_training_losses_match_jax(trained_densify):
    jt, pt, _ = trained_densify
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        for k in ("train/loss_sds", "train/loss_total"):
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-9), (row_j["step"], k)
