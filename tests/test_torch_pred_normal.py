"""``pred_normal`` in the port against the JAX package on the CPU: the
per-Gaussian ``normal`` field blended by the renderers as three extra
channels (``comp_pred_normal``, C = 7 through ``rasterize``), its gradient,
the MVDream system's predicted-normal loss over 3 training steps of
``gaussian_splatting_mvdream.yaml``, and the field riding through every
structural op, the checkpoint and the state converter.

Inputs come from numpy with a seed (the structural ops' states from
``tests/test_torch_densify.py``'s ``make_states``, the JAX draws fed in);
the tolerances are those of the files these cases extend:
``tests/test_torch_renderers.py`` (outputs 2e-5 absolute, gradients 1e-4
relative L2), ``tests/test_torch_mvdream.py`` (logs 1e-4 relative, fields
2% of their learning rate), ``tests/test_torch_densify.py`` (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_densify import (assert_state_matches, cap_prune_draws, densify_draws,
                                make_states)
from test_torch_mvdream import COMMON, LR_FRACTION
from test_torch_renderers import GRAD_REL, OUT_ATOL, make_pair, rel_l2
from test_torch_train import JAX_ONLY, ROOT

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models.convert import (extra_from_numpy,
                                                       gaussian_state_from_numpy, to_numpy)
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config

PRED_NORMAL = ["system.geometry.pred_normal=true", "system.loss.lambda_pred_normal=1.0"]


def with_normals(jstate, seed):
    """The JAX state with a seeded random ``normal`` field and Adam moments,
    and its port twin."""
    rng = np.random.default_rng(seed)
    cap = jstate.params.xyz.shape[0]
    n, mu, nu = (rng.normal(size=(cap, 3)).astype(np.float32) for _ in range(3))
    jstate = jstate.replace(
        params=jstate.params.replace(normal=jnp.asarray(n)),
        adam=jstate.adam.replace(mu=jstate.adam.mu.replace(normal=jnp.asarray(mu)),
                                 nu=jstate.adam.nu.replace(normal=jnp.asarray(np.abs(nu)))))
    return jstate, gaussian_state_from_numpy(jax.device_get(jstate), device="cpu")


def assert_normal_matches(got, want):
    want = jax.device_get(want)
    got = to_numpy(got)
    np.testing.assert_allclose(got["params"]["normal"], np.asarray(want.params.normal), rtol=0,
                               atol=1e-6)
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(got["adam"][m]["normal"],
                                      np.asarray(getattr(want.adam, m).normal))


@pytest.mark.parametrize("op", ["prune", "reset_opacity", "cap_prune", "densify"])
def test_structural_ops_carry_normal(op):
    """Each structural op on a field with normals: the whole state as
    tests/test_torch_densify.py holds it, and the normals with their
    moments (clones and split children copy theirs, zeroed moments)."""
    jstate, pstate = with_normals(make_states(21)[0], seed=22)
    key = jax.random.PRNGKey(23)
    if op == "prune":
        want = jgf.prune_op(jstate, jnp.float32(0.05), prune_big_points=True)
        got = pgf.prune_op(pstate, float(np.float32(0.05)), prune_big_points=True)
    elif op == "reset_opacity":
        want, got = jgf.reset_opacity_op(jstate), pgf.reset_opacity_op(pstate)
    elif op == "cap_prune":
        want = jgf.cap_prune_op(jstate, key, jnp.int32(250))
        got = pgf.cap_prune_op(pstate, 250, draws=cap_prune_draws(key))
    else:
        want = jgf.densify_op(jstate, key, jnp.float32(0.004), jnp.float32(0.02))
        got = pgf.densify_op(pstate, float(np.float32(0.004)), float(np.float32(0.02)),
                             draws=densify_draws(key))
        assert int(np.asarray(want.alive).sum()) > int(np.asarray(jstate.alive).sum())
    assert_state_matches(got, want)
    assert_normal_matches(got, want)


def test_checkpoint_and_converter_carry_normal(tmp_path):
    """The .npz checkpoint and both directions of the state converter keep
    the normal field and its moments bit for bit."""
    jstate, pstate = with_normals(make_states(31, n_alive=200, cap=256)[0], seed=32)
    path = str(tmp_path / "n.ckpt.npz")
    save_checkpoint(path, SystemState(gauss=pstate), 5)
    loaded, step = load_checkpoint(path, "cpu")
    assert step == 5
    for k, v in pstate.params.as_dict().items():
        assert torch.equal(getattr(loaded.gauss.params, k), v), k
    assert torch.equal(loaded.gauss.adam.mu["normal"], pstate.adam.mu["normal"])
    back = to_numpy(pstate)
    np.testing.assert_array_equal(back["params"]["normal"], np.asarray(jstate.params.normal))
    again = gaussian_state_from_numpy(jstate.replace(
        params=jstate.params.replace(**{k: jnp.asarray(v) for k, v in back["params"].items()})),
        device="cpu")
    assert torch.equal(again.params.normal, pstate.params.normal)


# ---------------------------------------------------------------------------
# The renderers' pred_normal channel
# ---------------------------------------------------------------------------

OUT_KEYS = ("comp_rgb", "comp_depth", "comp_mask", "comp_normal", "comp_pred_normal")
FIELDS = ("xyz", "features_dc", "scaling", "rotation", "opacity", "normal")


@pytest.mark.parametrize("renderer_type", ["diff-gaussian-rasterizer-normal",
                                           "diff-gaussian-rasterizer-shading"])
def test_pred_normal_channel_matches_jax(renderer_type):
    """The shading YAML's scene with random unit-scale normals, at eval: the
    outputs, comp_pred_normal among them, and the gradients of a random
    weighting of every output with respect to every field, the normal
    included (through K1/K2's plain twins at C = 7)."""
    pair = make_pair(renderer_type, ["system.geometry.pred_normal=true"])
    rng = np.random.default_rng(41)
    cap = pair.jstate.gauss.params.xyz.shape[0]
    normal = rng.normal(size=(cap, 3)).astype(np.float32)
    pair.jstate = pair.jstate.replace(gauss=pair.jstate.gauss.replace(
        params=pair.jstate.gauss.params.replace(normal=jnp.asarray(normal))))
    pair.pstate.gauss.params.normal = torch.tensor(normal)
    batch = pair.batch
    h, w = int(batch["height"]), int(batch["width"])
    weights = {k: rng.normal(size=(2, h, w, 1 if k in ("comp_depth", "comp_mask") else 3))
               .astype(np.float32) for k in OUT_KEYS}
    jb = dict(to_device_batch(batch), height=h, width=w)
    jr, pr = pair.jsys.renderer, pair.psys.renderer
    bg_j = pair.jstate.extra_params.get("background")

    def jax_loss(gp):
        out = jr.batch_forward(pair.jstate.gauss.replace(params=gp), jb, bg_params=bg_j,
                               key=None, ambient_only=jnp.asarray(False), training=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS if k in out), out

    (_, jout), jg = jax.value_and_grad(jax_loss, has_aux=True)(pair.jstate.gauss.params)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in pair.pstate.gauss.params.as_dict().items()}
    gs = dataclasses.replace(pair.pstate.gauss, params=pgf.GaussianParams(**leaves))
    pout = pr.batch_forward(gs, batch, bg_params=pair.pstate.extra_params.get("background"),
                            training=False)
    loss = sum(torch.sum(pout[k] * torch.tensor(weights[k])) for k in OUT_KEYS if k in pout)
    grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])
    for k in OUT_KEYS:
        got, want = pout[k].detach().numpy(), np.asarray(jout[k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL, err_msg=k)
    assert pout["comp_pred_normal"].shape == (2, h, w, 3)
    assert float(pout["comp_pred_normal"].detach().abs().max()) > 0.1
    alive = np.asarray(pair.jstate.gauss.alive)
    for f, g in zip(FIELDS, grads):
        want = np.asarray(getattr(jg, f))[alive]
        assert np.isfinite(g.numpy()[alive]).all(), f
        assert rel_l2(g.numpy()[alive], want) <= GRAD_REL, (f, rel_l2(g.numpy()[alive], want))
    assert np.abs(np.asarray(jg.normal)[alive]).max() > 0


# ---------------------------------------------------------------------------
# 3 training steps of the MVDream YAML with pred_normal
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained STEPS steps of the MVDream YAML with
    pred_normal and lambda_pred_normal = 1, from the JAX package's initial
    state (as tests/test_torch_mvdream.py trains it)."""
    root = tmp_path_factory.mktemp("pred_normal")
    overrides = COMMON + ["data.batch_size=4"] + PRED_NORMAL
    yaml = "gaussian_splatting_mvdream.yaml"
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{yaml}",
                                    overrides + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{yaml}",
                             overrides + [f"exp_root_dir={root / 'port'}"]), device="cpu")
    jt.system.prompt_utils.text_embedding = jnp.asarray(pt.system.prompt_utils.text_embedding)
    jt.state = jt.system.init_state(jt.cfg.seed)
    init = jax.device_get(jt.state)
    jt.fit()
    params, opt = extra_from_numpy(init.extra_params, init.extra_opt, device="cpu")
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init.gauss, device="cpu"),
                           extra_params=params, extra_opt=opt)
    pt.fit()
    return jt, pt, init


def test_pred_normal_training_logs_match_jax(trained):
    """Every train/ log of each step to 1e-4 relative, the predicted-normal
    loss among them, finite and positive."""
    jt, pt, _ = trained
    assert len(jt.metrics_log) == len(pt.metrics_log) == STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert "train/loss_pred_normal" in keys
        assert np.isfinite(row_p["train/loss_pred_normal"]) and row_p["train/loss_pred_normal"] > 0
        for k in keys:
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), k
        assert row_p["n_dropped_pairs"] == row_j["n_dropped_pairs"] == 0


@pytest.mark.parametrize("field", ["normal", "xyz", "features_dc", "scaling", "opacity"])
def test_pred_normal_trained_params_match_jax(trained, field):
    """Each field within 2% of its learning rate of the JAX package's after
    STEPS Adam steps, having moved by more than its learning rate (the
    normal at normal_lr)."""
    jt, pt, init = trained
    lr = pt.system.geometry.lr_tree(0)[field]
    want = np.asarray(getattr(jax.device_get(jt.state.gauss.params), field))
    got = getattr(pt.state.gauss.params, field).numpy()
    alive = pt.state.gauss.alive.numpy()
    np.testing.assert_allclose(got[alive], want[alive], rtol=0, atol=LR_FRACTION * lr)
    assert np.abs(want - np.asarray(getattr(init.gauss.params, field))).max() > lr
    assert pt.state.gauss.adam.count == STEPS
