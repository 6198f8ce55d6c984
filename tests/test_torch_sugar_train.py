"""The port's SuGaR static system (threestudio_3dgs_tpu_torch.systems.
sugar_static) against the JAX package on the CPU: 3 training steps of stage
"gaussian" on gs_to_sugar.yaml (the zero123 and ref substeps, the opacity,
density and SDF-normal regularisers, the TV trio) and 3 of stage "sugar" on
sugar_static_refine.yaml bound to one icosphere (the SuGaR renderer at 7
channels, normal consistency, Laplacian smoothing, TV), each from the JAX
package's initial state, on the Zero123 guidance's analytic prior with its
noise cancelled (min_step_percent == max_step_percent); then, in the port
alone, a ``--resume`` of the sugar stage and the launcher's entry points.

The JAX gaussian stage's SuGaR samples are recomputed from its step keys
and fed through the system's test-only ``step_draws``.  Losses are held to
1e-4 relative, the fields as ``tests/test_torch_gs4d.py`` holds its runs
(99% of the rows to 2% of the learning rate, every row to 2 lr a step:
Adam turns rounding into steps of up to its learning rate, ROADMAP
section 3)."""

import os

import imageio.v2 as imageio
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_gs4d import jax_step_keys
from test_torch_spacetime import sugar_draws
from test_torch_train import JAX_ONLY, ROOT

from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.models.convert import (
    gaussian_state_from_numpy,
    sugar_state_from_numpy,
    to_numpy,
)
from threestudio_3dgs_tpu_torch.models.sugar import SuGaRState
from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.saving import decode_png

STEPS = 3
SIZE = 64
CAP = 512
N_SAMPLES = 64  # SuGaR's samples per loss (the YAML's 500k cut to the test's size)
LR_FRACTION = 0.02
COMMON = [
    f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
    "data.image_path=", f"data.height={SIZE}", f"data.width={SIZE}",
    f"data.random_camera.height={SIZE}", f"data.random_camera.width={SIZE}",
    "data.random_camera.batch_size=1", "data.random_camera.eval_height=32",
    "data.random_camera.eval_width=32", "data.random_camera.n_test_views=2",
    "data.random_camera.n_val_views=1",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.batched=false", "system.renderer.adaptive_max_pairs=false",
    "system.guidance.min_step_percent=0.5", "system.guidance.max_step_percent=0.5",
]
STAGES = {
    "gaussian": ("gs_to_sugar", [
        "system.geometry.init_num_pts=256", f"system.geometry.capacity={CAP}",
        f"system.sugar.n_samples_for_sdf_regularization={N_SAMPLES}"]),
    "sugar": ("sugar_static_refine", []),
}
FIELDS = {
    "gaussian": ("xyz", "features_dc", "scaling", "rotation", "opacity"),
    "sugar": ("points", "sh_dc", "scales", "densities"),
}
EXPECTED_LOGS = {
    "gaussian": {"train/loss_zero123_sds", "train/loss_ref_rgb", "train/loss_opacity_binary",
                 "train/loss_density_regulation", "train/sugar_beta",
                 "train/loss_normal_regulation", "train/loss_rgb_tv", "train/loss_normal_tv"},
    "sugar": {"train/loss_zero123_sds", "train/loss_ref_rgb", "train/loss_normal_consistency",
              "train/loss_laplacian_smoothing", "train/loss_tv", "train/loss_depth_tv"},
}


def gaussian_stage_draws(seed, steps):
    """Per step, the JAX gaussian stage's SuGaR samples (density, then
    normal) from its key chain: the zero123 substep's render, guidance and
    ambient keys and its 2D-SDS key, the ref substep's render key, then the
    extra losses' key."""
    out = {}
    for step, k in enumerate(jax_step_keys(seed, steps)):
        k = jax.random.split(k, 4)[0]  # zero123 substep
        k = jax.random.split(k)[0]  # its 2D SDS
        k = jax.random.split(k)[0]  # ref substep render
        k_x = jax.random.split(k)[1]  # the ref substep's extra losses
        k1, k_x = jax.random.split(k_x)
        k2, _ = jax.random.split(k_x)
        out[step] = {"density": sugar_draws(k1, N_SAMPLES, CAP),
                     "normal": sugar_draws(k2, N_SAMPLES, CAP)}
    return out


def make_trainers(stage, root, overrides=(), opacity_spread=0.0):
    """Both trainers, each holding the JAX package's initial state: the
    gaussian stage's field with its log-scales + N(0, 0.3^2) (an isotropic
    Gaussian's rotation gradient is rounding, and the SuGaR losses read
    the smallest axis) and its opacity logits + N(0, opacity_spread^2);
    the sugar stage's icosphere bound in both."""
    config, extra = STAGES[stage]
    over = COMMON + extra + list(overrides)
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{config}.yaml",
                                    over + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{config}.yaml",
                             over + [f"exp_root_dir={root / 'port'}"]), device="cpu")
    if stage == "sugar":
        verts, faces = icosphere()
        jt.system.bind_mesh(verts, faces)
        pt.system.bind_mesh(verts, faces)
        jt.state = jt.system.init_state(jt.cfg.seed)
        init = jax.device_get(jt.state.gauss)
        pt.state = SystemState(gauss=sugar_state_from_numpy(init, device="cpu"))
        return jt, pt, init
    state = jt.system.init_state(jt.cfg.seed)
    params = state.gauss.params
    rng = np.random.default_rng(5)
    noise = rng.normal(size=params.scaling.shape).astype(np.float32) * 0.3
    spread = rng.normal(size=params.opacity.shape).astype(np.float32) * opacity_spread
    params = params.replace(scaling=params.scaling + jnp.asarray(noise),
                            opacity=params.opacity + jnp.asarray(spread))
    jt.state = state.replace(gauss=state.gauss.replace(params=params))
    init = jax.device_get(jt.state.gauss)
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
    pt.system.step_draws = gaussian_stage_draws(jt.cfg.seed, STEPS).get
    return jt, pt, init


@pytest.fixture(scope="module", params=sorted(STAGES))
def trained(request, tmp_path_factory):
    """Both packages trained STEPS steps of one stage."""
    stage = request.param
    jt, pt, init = make_trainers(stage, tmp_path_factory.mktemp(f"sugar_{stage}"))
    jt.fit()
    pt.fit()
    return stage, jt, pt, init


def test_training_logs_match_jax(trained):
    """Every train/ log of each step to 1e-4 relative, no dropped pairs;
    the sugar stage logs its face count."""
    stage, jt, pt, _ = trained
    assert len(jt.metrics_log) == len(pt.metrics_log) == STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert EXPECTED_LOGS[stage] <= set(keys), set(keys)
        for k in keys:
            assert np.isfinite(row_p[k])
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), (stage, k)
        assert row_p["n_dropped_pairs"] == 0
        if stage == "sugar":
            assert row_p["n_faces"] == row_j["n_faces"] == 320


def test_trained_params_match_jax(trained):
    """Each field: 99% of the (alive) rows within 2% of its learning rate
    of the JAX package's, every row within 2 lr per step, having moved by
    more than half its learning rate; dead rows untouched; the sugar
    stage's faces, barycentric table and Adam count unchanged.  The sugar
    stage's in-plane rotation is held through the covariance it gives
    (its two tangent scales start equal, so its gradient is rounding that
    Adam turns into steps of +-lr, as for an isotropic Gaussian)."""
    stage, jt, pt, init = trained
    want_state, got = jax.device_get(jt.state.gauss), to_numpy(pt.state.gauss)
    lrs = pt.system.geometry.lr_tree(0)
    rows = np.asarray(want_state.alive) if stage == "gaussian" else slice(None)
    for field in FIELDS[stage]:
        lr = lrs[field]
        want = np.asarray(getattr(want_state.params, field))
        diff = np.abs(got["params"][field] - want).reshape(want.shape[0], -1)[rows].max(-1)
        assert (diff <= LR_FRACTION * lr).mean() >= 0.99, (field, np.sort(diff)[-5:])
        assert diff.max() <= 2 * lr * STEPS, field
        before = np.asarray(getattr(init.params, field))
        assert np.abs(want - before).max() > 0.5 * lr, field
        if stage == "gaussian":
            dead = ~np.asarray(want_state.alive)
            np.testing.assert_array_equal(got["params"][field][dead], before[dead])
    if stage == "sugar":
        geo = pt.system.geometry

        def covs(state):
            arrays = geo.as_gaussian_arrays(state)
            return covariance_from_scaling_rotation(arrays["scales"], arrays["quats"]).numpy()

        want_cov = covs(sugar_state_from_numpy(want_state, device="cpu"))
        np.testing.assert_allclose(covs(pt.state.gauss), want_cov, rtol=0,
                                   atol=1e-4 * np.abs(want_cov).max())
        np.testing.assert_array_equal(got["faces"], np.asarray(want_state.faces))
        np.testing.assert_array_equal(got["bary"], np.asarray(want_state.bary))
        assert got["adam"]["count"] == int(want_state.adam.count) == STEPS


def test_sugar_prune_through_update_states(tmp_path):
    """Stage "gaussian" with ``sugar_prune_at`` at step 0, from opacities
    spread around the threshold (logits + N(0, 1)): after that step both
    packages keep the same rows, those with opacity >= 0.05."""
    jt, pt, _ = make_trainers("gaussian", tmp_path, [
        "trainer.max_steps=1", "system.geometry.sugar_prune_at=0",
        "system.geometry.sugar_prune_threshold=0.05"], opacity_spread=1.0)
    jt.fit()
    pt.fit()
    alive = np.asarray(jt.state.gauss.alive)
    assert 0 < alive.sum() < 256
    np.testing.assert_array_equal(pt.state.gauss.alive.numpy(), alive)
    assert [r["gauss_num"] for r in pt.metrics_log] == [r["gauss_num"] for r in jt.metrics_log]


def test_sugar_stage_resume_and_entry_points(tmp_path):
    """The sugar stage through the launcher on the CPU, bound through
    ``geometry_convert_from`` to an .obj: --train (the test renders and the
    PLY of every bound Gaussian), the checkpoint's SuGaR state read back
    equal, --resume continuing at its step, and --predict (with the border
    postprocess on) baking the textured mesh: its OBJ and MTL bytes equal
    to the JAX package's ``predict_textured_mesh`` on the same state, its
    PNG pixels too (a texel whose JAX value lies within 1e-3 of a step of
    the 8-bit cast may round either way, as the two packages' renders
    differ by rounding: such ties are counted, none on these renders)."""
    verts, faces = icosphere(1)
    obj = tmp_path / "mesh.obj"
    with open(obj, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/sugar_static_refine.yaml"
    flags = ["--config", config, "--device", "cpu"]
    over = [f"system.geometry_convert_from={obj}",
            "system.geometry.n_gaussians_per_surface_triangle=1",
            "data.random_camera.height=32", "data.random_camera.width=32"]
    over += [o for o in COMMON if not o.startswith(("trainer.max_steps", "data.random_camera.h",
                                                    "data.random_camera.w"))]
    # each launch under its own root: two launches within one second share a
    # trial directory (its name carries the time to the second)
    first = launch.main(flags + ["--train"] + over + ["trainer.max_steps=2",
                                                      f"exp_root_dir={tmp_path / 'a'}"])
    assert first.system.geometry.topology.edge_faces.shape == (120, 2)
    ply = f"{first.save_dir}/save/point_cloud.ply"
    from threestudio_3dgs_tpu_torch.models.ply_io import read_ply_table

    assert len(read_ply_table(ply)["x"]) == 80
    ckpt = f"{first.save_dir}/ckpts/last.ckpt.npz"
    state, step = load_checkpoint(ckpt, "cpu")
    assert step == 2 and isinstance(state.gauss, SuGaRState)
    for k, v in first.state.gauss.params.as_dict().items():
        assert torch.equal(getattr(state.gauss.params, k), v), k
        assert torch.equal(state.gauss.adam.nu[k], first.state.gauss.adam.nu[k]), k
    assert torch.equal(state.gauss.faces, first.state.gauss.faces)
    assert state.gauss.adam.count == 2
    resumed = launch.main(flags + ["--train", "--resume", ckpt] + over
                          + ["trainer.max_steps=3", f"exp_root_dir={tmp_path / 'b'}"])
    assert resumed.step == 3 and resumed.state.gauss.adam.count == 3
    assert len(resumed.metrics_log) == 1 and np.isfinite(resumed.metrics_log[0]["train/loss_total"])
    predict = ["--predict", "--resume", ckpt, "system.postprocess=true"]
    baked = launch.main(flags + predict + over + [f"exp_root_dir={tmp_path / 'c'}"])
    out_dir = f"{baked.save_dir}/save/it2-predict"
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/sugar_static_refine.yaml",
                                    over + JAX_ONLY + ["system.postprocess=true",
                                                       f"exp_root_dir={tmp_path / 'j'}"]))
    jax_system_state = jt.system.init_state(jt.cfg.seed)
    jax_state = jax_system_state.gauss
    np.testing.assert_array_equal(np.asarray(jax_state.faces), state.gauss.faces.numpy())
    params = {k: jnp.asarray(v.numpy()) for k, v in state.gauss.params.as_dict().items()}
    jax_state = jax_state.replace(params=jax_state.params.replace(**params))
    jax_dir = tmp_path / "j" / "predict"
    os.makedirs(jax_dir)
    jt.state = jax_system_state.replace(gauss=jax_state)
    jt.system.predict_textured_mesh(jt.state, jt.data.test_views(),
                                    str(jax_dir / "textured_mesh.obj"))
    for ext in (".obj", ".mtl"):
        with open(f"{out_dir}/textured_mesh{ext}", "rb") as f, \
                open(jax_dir / f"textured_mesh{ext}", "rb") as g:
            assert f.read() == g.read(), ext
    obj = open(f"{out_dir}/textured_mesh.obj").read()
    assert obj.count("\nvt ") == 3 * 80 and obj.count("\nf ") == 80
    with open(f"{out_dir}/textured_mesh.png", "rb") as f:
        got = decode_png(f.read())
    want = imageio.imread(jax_dir / "textured_mesh.png")
    assert got.shape == want.shape and got.shape[0] > 32
    # the JAX texture before its cast: the 8-bit step a texel lies nearest
    step = np.clip(jax_texture(jt, jax_state), 0, 1) * 255
    tie = np.abs(step - np.round(step)) <= 1e-3
    differ = got != want
    assert not (differ & ~tie).any()
    assert differ.sum() == 0, differ.sum()  # the counted ties: none on these renders


def jax_texture(jt, jax_state):
    """The JAX package's baked texture of ``jax_state`` before the 8-bit
    cast, through its own ``extract_textured_mesh`` with the save stubbed."""
    from threestudio_3dgs_tpu.models import texture_bake

    got = {}
    saved = texture_bake.save_textured_obj_uv
    texture_bake.save_textured_obj_uv = lambda *a: got.setdefault("texture", a[-1])
    try:
        texture_bake.extract_textured_mesh(
            jt.system.geometry, jax_state, lambda vs: jt.system.render_views(
                jt.state.replace(gauss=jax_state), vs), jt.data.test_views(), "unused.obj",
            square_size=jt.system.geometry.cfg.square_size_in_texture)
    finally:
        texture_bake.save_textured_obj_uv = saved
    return np.asarray(got["texture"])
