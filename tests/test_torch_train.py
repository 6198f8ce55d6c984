"""The port's SDS training slice against the JAX package on the CPU:
3 training steps of gaussian_splatting.yaml in both packages from one
initial state, state conversion, the port's isolation from JAX, and the
parts it still defers (which must raise, never skip)."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy, to_numpy
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.config import load_config



def share_cpu_threads() -> int:
    """Gives this process's torch an equal share of the CPU's cores: one
    intra-op thread per core and pytest-xdist worker (all the cores when
    the tests run in one process).  Each worker running torch's default
    pool, one thread per core, oversubscribes the CPU, and the plain
    twins' elementwise ops then take several times their time alone."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // max(workers, 1))
    torch.set_num_threads(threads)
    return threads


share_cpu_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CONFIG = os.path.join(ROOT, "threestudio_3dgs_tpu", "configs", "gaussian_splatting.yaml")
PORT_CONFIG = os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs", "gaussian_splatting.yaml")
STEPS = 3

# gaussian_splatting.yaml at 64^2, B=2, tile 16, 256 points in a 1536 field,
# with the stochastic parts pinned: invert_bg_prob=1.0 never inverts the
# background, and min_step_percent == max_step_percent fixes t, so the
# analytic denoiser's noise cancels from eps - noise up to rounding.  Both
# packages render view by view (the JAX package's batched pass is off).
OVERRIDES = [
    f"trainer.max_steps={STEPS}",
    "trainer.val_check_interval=0",
    "data.width=64",
    "data.height=64",
    "data.batch_size=2",
    "system.geometry.init_num_pts=256",
    "system.geometry.capacity=1536",
    "system.renderer.tile_size=16",
    "system.renderer.adaptive_max_pairs=false",
    "system.renderer.invert_bg_prob=1.0",
    "system.renderer.max_pairs=65536",
    "system.renderer.batched=false",
    "system.guidance_type=fake-sds-guidance",
    "system.guidance={target_color: [0.8, 0.2, 0.2], guidance_scale: 3.0, "
    "min_step_percent: 0.5, max_step_percent: 0.5}",
]
# the JAX trainer would shard the camera batch over the test's virtual CPU
# mesh (per-shard SDS normalisation); trainer.devices=0 keeps its
# single-device step, the one the port mirrors
JAX_ONLY = ["trainer.devices=0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained STEPS steps from the JAX package's initial
    state (carried over with gaussian_state_from_numpy)."""
    root = tmp_path_factory.mktemp("train")
    jt = JaxTrainer(jax_load_config(
        JAX_CONFIG, OVERRIDES + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    jt.state = jt.system.init_state(jt.cfg.seed)
    init = jax.device_get(jt.state.gauss)
    jt.fit()
    pt = Trainer(load_config(PORT_CONFIG, OVERRIDES + [f"exp_root_dir={root / 'port'}"]),
                 device="cpu")
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
    pt.fit()
    return jt, pt, init


def test_training_logs_match_jax(trained):
    jt, pt, _ = trained
    assert len(jt.metrics_log) == len(pt.metrics_log) == STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert "train/loss_sds" in keys and "train/loss_tv" in keys
        for k in keys:
            # the SDS residual eps - noise cancels the noise only up to
            # f32 rounding, and the renders agree to ~1e-6: 1e-4 relative
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-9), k
        for k in ("n_pairs_max", "n_dropped_pairs", "gauss_num"):
            assert row_p[k] == row_j[k], k
        assert row_p["n_dropped_pairs"] == 0


# Adam divides each gradient entry by its running RMS, so an entry whose
# gradient is tiny against f32 rounding (e.g. the rotation of a near-
# isotropic Gaussian) can move by a sizeable part of its learning rate in
# either package: fields with lr >= 0.005 are held to 1e-3 absolute, the
# position (lr 1e-3 decaying) and colour to 2e-5.
PARAM_ATOL = {"xyz": 2e-5, "features_dc": 2e-5, "scaling": 1e-3, "rotation": 1e-3,
              "opacity": 1e-3}


@pytest.mark.parametrize("field", sorted(PARAM_ATOL))
def test_trained_params_match_jax(trained, field):
    jt, pt, init = trained
    want = np.asarray(getattr(jax.device_get(jt.state.gauss.params), field))
    got = getattr(pt.state.gauss.params, field).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL[field])
    moved = np.abs(want - np.asarray(getattr(init.params, field))).max()
    assert moved > 5 * PARAM_ATOL[field], moved  # the tolerance is well under the motion
    dead = ~np.asarray(jt.state.gauss.alive)
    np.testing.assert_array_equal(got[dead], np.asarray(getattr(init.params, field))[dead])


def test_trained_stats_match_jax(trained):
    jt, pt, _ = trained
    g = jax.device_get(jt.state.gauss)
    np.testing.assert_array_equal(pt.state.gauss.max_radii2d.numpy(), np.asarray(g.max_radii2d))
    np.testing.assert_array_equal(pt.state.gauss.denom.numpy(), np.asarray(g.denom))
    # sums of NDC gradient norms of the means2d side channel: 1e-5 of the max
    want = np.asarray(g.xyz_grad_accum)
    assert want.max() > 0
    np.testing.assert_allclose(pt.state.gauss.xyz_grad_accum.numpy(), want, rtol=0,
                               atol=1e-5 * want.max())
    assert pt.state.gauss.adam.count == int(g.adam.count) == STEPS


def test_port_init_matches_jax():
    """The port's own random-sphere init draws the JAX package's points
    (numpy RNG) and the same k-NN scales."""
    kw = dict(init_num_pts=256, capacity=1536, opacity_init=0.2)
    want = jax.device_get(jgf.init_state(jgf.GaussianFieldConfig(**kw), seed=3))
    got = pgf.init_state(pgf.GaussianFieldConfig(**kw), seed=3, device="cpu")
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for name in pgf.PARAM_FIELDS:
        w = getattr(want.params, name)
        if w is None:
            assert getattr(got.params, name) is None
            continue
        # the k-NN distances go through an f32 matrix product in both
        np.testing.assert_allclose(getattr(got.params, name).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_state_conversion_round_trip(trained):
    jt, _, _ = trained
    g = jax.device_get(jt.state.gauss)
    back = to_numpy(gaussian_state_from_numpy(g, device="cpu"))
    for name, arr in back["params"].items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(g.params, name)))
        np.testing.assert_array_equal(back["adam"]["mu"][name], np.asarray(getattr(g.adam.mu, name)))
        np.testing.assert_array_equal(back["adam"]["nu"][name], np.asarray(getattr(g.adam.nu, name)))
    assert back["adam"]["count"] == int(g.adam.count)
    for name in ("alive",) + pgf.STAT_FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(g, name)))


def test_checkpoint_written(trained):
    _, pt, _ = trained
    from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint_arrays

    arrays, step = load_checkpoint_arrays(os.path.join(pt.save_dir, "ckpts", "last.ckpt.npz"))
    assert step == STEPS
    np.testing.assert_array_equal(arrays["gauss/params/xyz"], pt.state.gauss.params.xyz.numpy())


# ---------------------------------------------------------------------------
# Isolation and entry points
# ---------------------------------------------------------------------------


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter, importing every port module (the diffusion
    stack, K5's module, the eval and export modules, the image-to-3D and
    the 4D modules included) and training one CPU step through the launcher,
    with the YAML's own stable-diffusion-guidance on a tiny random
    checkpoint directory, then
    the test renders and the export, leaves neither jax nor the JAX package
    in sys.modules."""
    code = (
        "import sys\n"
        "from threestudio_3dgs_tpu_torch import launch\n"
        "from threestudio_3dgs_tpu_torch.diffusion import convert, unet, vae\n"
        "from threestudio_3dgs_tpu_torch.guidance import clip, stable_diffusion, temporal_zero123\n"
        "from threestudio_3dgs_tpu_torch.data import image\n"
        "from threestudio_3dgs_tpu_torch.systems import gaussian_zero123\n"
        "from threestudio_3dgs_tpu_torch.models import decimate, exporter, mesh_extract, ply_io\n"
        "from threestudio_3dgs_tpu_torch.ops import flash_attention, native\n"
        "from threestudio_3dgs_tpu_torch.utils import ckpt, profiling, saving\n"
        "from threestudio_3dgs_tpu_torch.ops import arap, lie, spline, sugar_reg\n"
        "from threestudio_3dgs_tpu_torch.models import deformation, gaussian_dynamic, spacetime\n"
        "from threestudio_3dgs_tpu_torch.data import temporal_image\n"
        "from threestudio_3dgs_tpu_torch.systems import gaussian_4dgen, sugar_static\n"
        "ucfg = unet.UNet2DConditionConfig(block_out_channels=(32, 64), "
        "attention_head_dim=(2, 4), down_block_types=('CrossAttnDownBlock2D', 'DownBlock2D'), "
        "up_block_types=('UpBlock2D', 'CrossAttnUpBlock2D'), norm_groups=8)\n"
        "vcfg = vae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)\n"
        f"convert.write_random_checkpoint({str(tmp_path / 'sd')!r}, ucfg, vcfg, device='cpu')\n"
        f"launch.main(['--config', {PORT_CONFIG!r}, '--train', '--export', '--device', 'cpu', "
        f"'exp_root_dir={tmp_path}', 'trainer.max_steps=1', 'trainer.val_check_interval=0', "
        "'data.width=32', 'data.height=32', 'data.batch_size=1', "
        "'data.eval_width=32', 'data.eval_height=32', 'data.n_test_views=2', "
        "'system.exporter.resolution=32', "
        "'system.geometry.init_num_pts=64', 'system.geometry.capacity=128', "
        "'system.renderer.tile_size=16', "
        f"'system.guidance.pretrained_model_name_or_path={tmp_path / 'sd'}'])\n"
        "bad = [m for m in ('jax', 'jaxlib', 'threestudio_3dgs_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout
    for line in ("train/loss_sds", "test renders ->", "export ->"):
        assert line in res.stdout, line


def test_launch_refuses_cpu_fallback(monkeypatch):
    """Without a card and without --device cpu the launcher raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.main(["--config", PORT_CONFIG, "--train"])


def test_deferred_parts_raise(tmp_path):
    """A geometry_convert_from the port cannot initialise from raises,
    never a silent fallback to the random sphere: a source of no known
    kind (where the JAX package takes the sphere), and a point cloud or a
    checkpoint that is not there, through init_state and the launcher.
    (The sources it takes are held against the JAX package in
    tests/test_torch_init.py.)"""
    for source, error in (("mesh.obj", ValueError),
                          (str(tmp_path / "points.ply"), FileNotFoundError),
                          (str(tmp_path / "last.ckpt.npz"), FileNotFoundError)):
        cfg = pgf.GaussianFieldConfig(geometry_convert_from=source, init_num_pts=8, capacity=16)
        with pytest.raises(error):
            pgf.init_state(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="points.ply"):
        launch.main(["--config", PORT_CONFIG, "--validate", "--device", "cpu",
                     f"exp_root_dir={tmp_path}", "system.guidance_type=fake-sds-guidance",
                     f"system.geometry_convert_from={tmp_path / 'points.ply'}"])
