"""The port's video-to-4D system (threestudio_3dgs_tpu_torch.systems.
gaussian_4dgen) against the JAX package on the CPU: 3 training steps of
gs4d_motion.yaml (polynomial motion, the ref-frame anchor and the lite
ARAP), gs4d.yaml (spline with per-frame deltas) and gs4d_static.yaml (the
static stage with SuGaR's opacity, density and normal regularisers) on the
analytic prior; one step of gs4d_motion through ``attach_video_frames`` on
a tiny Stable Zero123 checkpoint; and the port alone: the deformation
network's training, checkpoints and ``--resume``, the launcher's entry
points on a spacetime run, and its isolation from JAX.

The JAX package's draws of each step (the lite ARAP's time, SuGaR's
samples, the guidance's encoder noise and SDS noise) are recomputed here
from its step keys and reach the port through the system's test-only
``step_draws``.  Losses are held to 1e-4 relative, parameters to 2% of
their learning rate (ROADMAP section 3: Adam turns rounding into steps of
up to its learning rate)."""

import fcntl
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_guidance import nchw
from test_torch_mvdream import jax_draws
from test_torch_spacetime import sugar_draws, write_frames
from test_torch_train import JAX_ONLY, ROOT
from test_torch_zero123 import CLIP_DIM, TINY_UNET, TINY_VAE

from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch.diffusion import convert as pconv
from threestudio_3dgs_tpu_torch.models import spacetime as pst
from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
from threestudio_3dgs_tpu_torch.systems import gaussian_4dgen as p4d
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

STEPS = 3
SIZE = 64
CAP = 512
N_SAMPLES = 64  # SuGaR's samples per loss (the YAML's 500k cut to the test's size)
COMMON = [
    f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
    f"data.height={SIZE}", f"data.width={SIZE}", f"data.random_camera.height={SIZE}",
    f"data.random_camera.width={SIZE}", "data.random_camera.batch_size=1",
    "system.geometry.init_num_pts=256", f"system.geometry.capacity={CAP}",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.batched=false", "system.renderer.adaptive_max_pairs=false",
]
# 3 frames; min_step_percent == max_step_percent so the analytic prior's
# noise cancels from its target
TEMPORAL = ["data.video_length=3", "data.num_frames=3", "system.geometry.num_frames=4",
            "system.guidance_zero123.min_step_percent=0.5",
            "system.guidance_zero123.max_step_percent=0.5"]
CONFIGS = {
    "gs4d_motion": TEMPORAL,
    "gs4d": TEMPORAL,
    "gs4d_static": ["data.image_path=", "system.guidance.min_step_percent=0.5",
                    "system.guidance.max_step_percent=0.5",
                    f"system.sugar.n_samples_for_sdf_regularization={N_SAMPLES}"],
}
LR_FRACTION = 0.02
FIELDS = {
    "gs4d_motion": ("xyz", "features_dc", "scaling", "rotation", "opacity", "motion", "omega"),
    "gs4d": ("xyz", "features_dc", "scaling", "rotation", "opacity", "delta_xyz", "delta_rot"),
    "gs4d_static": ("xyz", "features_dc", "scaling", "rotation", "opacity"),
}


def jax_step_keys(seed, steps):
    """The key each JAX train step splits: the trainer's chain, then the
    step's own k_step (k_struct goes to the structural update)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.split(sub)[0])
    return out


def jax_step_draws(config, seed, steps, guidance=None):
    """Per step, the draws the JAX 4D step makes, in its order: the
    zero123 substep's guidance key, the ref substep's, then the static
    stage's SuGaR samples (density, then normal) or the motion stage's lite
    ARAP time.  ``guidance`` (sched, latent shape): also the guidance's
    encoder noise, timestep and SDS noise."""
    out = {}
    for step, k in enumerate(jax_step_keys(seed, steps)):
        k, _, k_g = jax.random.split(k, 3)  # zero123 substep: render, guidance
        k, _ = jax.random.split(k)  # ref substep: render
        k, k_x = jax.random.split(k)  # ref substep: its extra losses
        d = {}
        if config == "gs4d_static":
            k1, k_x = jax.random.split(k_x)
            d["density"] = sugar_draws(k1, N_SAMPLES, CAP)
            k2, k_x = jax.random.split(k_x)
            d["normal"] = sugar_draws(k2, N_SAMPLES, CAP)
        else:
            _, k_m = jax.random.split(k)
            d["arap_t"] = np.array(jax.random.uniform(jax.random.split(k_m)[0]))
        if guidance is not None:
            sched, latent = guidance
            k_enc, k_g = jax.random.split(k_g)
            t, noise = jax_draws(k_g, sched, latent[0], 1, latent)
            d["guidance"] = {"latent_noise": nchw(np.asarray(jax.random.normal(k_enc, latent))),
                             "t": t, "noise": nchw(noise)}
        out[step] = d
    return out


def make_trainers(config, overrides, root):
    """Both trainers, each holding the JAX package's initial field with
    its scales made anisotropic (each log-scale + N(0, 0.3^2), from numpy):
    an isotropic Gaussian's rotation gradient is rounding, which Adam turns
    into steps of +-lr (ROADMAP section 3), and the SuGaR losses read the
    rotation through the smallest axis and the covariance."""
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{config}.yaml",
                                    overrides + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{config}.yaml",
                             overrides + [f"exp_root_dir={root / 'port'}"]), device="cpu")
    state = jt.system.init_state(jt.cfg.seed)
    params = state.gauss.params
    noise = np.random.default_rng(5).normal(size=params.scaling.shape).astype(np.float32) * 0.3
    params = params.replace(scaling=params.scaling + jnp.asarray(noise))
    jt.state = state.replace(gauss=state.gauss.replace(params=params))
    init = jax.device_get(jt.state.gauss)
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
    return jt, pt, init


def train_both(config, root):
    """Both packages trained STEPS steps from the JAX package's initial
    state, the port fed the JAX draws: the logs, the initial and trained
    fields and the learning rates."""
    jt, pt, init = make_trainers(config, COMMON + CONFIGS[config], root)
    draws = jax_step_draws(config, jt.cfg.seed, STEPS)
    pt.system.step_draws = draws.get
    jt.fit()
    pt.fit()
    jg, pg = jax.device_get(jt.state.gauss), pt.state.gauss
    arrays = {"alive": np.asarray(jg.alive)}
    for field in FIELDS[config]:
        arrays[f"init/{field}"] = np.asarray(getattr(init.params, field))
        arrays[f"jax/{field}"] = np.asarray(getattr(jg.params, field))
        arrays[f"port/{field}"] = getattr(pg.params, field).numpy()
    for stat in ("denom", "xyz_grad_accum"):
        arrays[f"jax/{stat}"] = np.asarray(getattr(jg, stat))
        arrays[f"port/{stat}"] = getattr(pg, stat).numpy()
    meta = {"jax_logs": jt.metrics_log, "port_logs": pt.metrics_log,
            "lrs": pt.system.geometry.lr_tree(0)}
    return meta, arrays


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trained(request, tmp_path_factory):
    """``train_both`` once per configuration in a test session (under
    pytest-xdist the first worker to take the lock trains, the others read
    its results)."""
    name = request.param
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = shared / f"gs4d_{name}.json"
    with open(shared / f"gs4d_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            meta, arrays = train_both(name, tmp_path_factory.mktemp(f"gs4d_{name}"))
            np.savez(shared / f"gs4d_{name}.npz", **arrays)
            done.write_text(json.dumps(meta))
    with np.load(shared / f"gs4d_{name}.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return name, json.loads(done.read_text()), arrays


EXPECTED_LOGS = {
    "gs4d_motion": {"train/loss_ref_gs", "train/loss_lite_arap_reg"},
    "gs4d": {"train/loss_ref_gs", "train/loss_lite_arap_reg"},
    "gs4d_static": {"train/loss_opacity_binary", "train/loss_density_regulation",
                    "train/sugar_beta", "train/loss_normal_regulation"},
}


def test_training_logs_match_jax(trained):
    """Every train/ log of each step (both substeps, PSNR, the stage's
    regularisers) to 1e-4 relative (1e-7 absolute for the lite ARAP's
    rounding-level first step), no dropped pairs."""
    name, meta, _ = trained
    assert len(meta["jax_logs"]) == len(meta["port_logs"]) == STEPS
    for row_j, row_p in zip(meta["jax_logs"], meta["port_logs"]):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert {"train/loss_zero123_sds", "train/loss_ref_rgb", "train/psnr"} <= set(keys)
        assert EXPECTED_LOGS[name] <= set(keys)
        for k in keys:
            assert np.isfinite(row_p[k])
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), (name, k)
        assert row_p["n_dropped_pairs"] == 0


def test_trained_params_match_jax(trained):
    """Each field (the motion stage's temporal ones included): 99% of the
    alive rows within 2% of its learning rate of the JAX package's and
    every row within 2 lr per step, having moved by more than half its
    learning rate (Adam's first step moves an entry by its learning rate,
    later ones of the other sign take some back); dead rows untouched.
    The bound on the rest: a row at a discontinuity of the rasterizer can
    take a different gradient from states that differ by rounding, in the
    JAX package alone too (ROADMAP section 3)."""
    name, meta, arrays = trained
    alive, dead = arrays["alive"], ~arrays["alive"]
    for field in FIELDS[name]:
        lr = meta["lrs"][field]
        want = arrays[f"jax/{field}"]
        diff = np.abs(arrays[f"port/{field}"] - want).reshape(want.shape[0], -1)[alive].max(-1)
        assert (diff <= LR_FRACTION * lr).mean() >= 0.99, (field, np.sort(diff)[-5:])
        assert diff.max() <= 2 * lr * STEPS, field
        assert np.abs(want - arrays[f"init/{field}"]).max() > 0.5 * lr, field
        np.testing.assert_array_equal(arrays[f"port/{field}"][dead], arrays[f"init/{field}"][dead])


def test_trained_covariances_match_jax(trained):
    """The covariances of the trained scales and rotations (for gs4d each
    frame's rotation + delta_rot): to 1e-4 of the largest entry."""
    name, _, arrays = trained

    def covs(pkg):
        scales = torch.exp(torch.tensor(arrays[f"{pkg}/scaling"]))
        rot = torch.tensor(arrays[f"{pkg}/rotation"])
        rots = [rot]
        if "delta_rot" in FIELDS[name]:
            delta = torch.tensor(arrays[f"{pkg}/delta_rot"])
            rots = [rot + delta[:, f] for f in range(delta.shape[1])]
        return np.stack([covariance_from_scaling_rotation(scales, r).numpy() for r in rots])

    want = covs("jax")
    np.testing.assert_allclose(covs("port"), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_trained_stats_match_jax(trained):
    """The densification statistics of the last substep (the ref frames):
    visibility counts equal; the NDC gradient norms of 99% of the alive
    rows to 1e-4 of their largest, every row's to 1e-3 (a row at a
    discontinuity, as above)."""
    _, _, arrays = trained
    np.testing.assert_array_equal(arrays["port/denom"], arrays["jax/denom"])
    want = arrays["jax/xyz_grad_accum"]
    diff = np.abs(arrays["port/xyz_grad_accum"] - want)[arrays["alive"]] / np.abs(want).max()
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 1e-3, np.sort(diff)[-5:]


def test_attach_video_frames_tiny_denoiser(tmp_path, monkeypatch):
    """gs4d_motion with the temporal Zero123 guidance on a tiny ldm
    checkpoint (f32, 32^2 views, conditioning size 32): the trainers hand both
    guidances the video frames, both build the denoiser (c_concat and the
    stand-in CLIP embeddings to 1e-5), and one training step with the JAX
    draws gives the same losses (1e-4 relative) and fields (2% of the
    learning rate)."""
    ckpt = tmp_path / "z123" / "tiny.ckpt"
    os.makedirs(ckpt.parent)
    pconv.write_random_ldm_checkpoint(str(ckpt), TINY_UNET, TINY_VAE, clip_dim=CLIP_DIM, seed=3,
                                      device="cpu")
    # frames of random colours: the synthetic square's flat white makes the
    # VAE's group norms divide rounding by near-zero variances
    os.makedirs(tmp_path / "frames")
    write_frames(tmp_path / "frames", n=3)
    overrides = [o.replace(f"trainer.max_steps={STEPS}", "trainer.max_steps=1")
                 .replace(f"={SIZE}", "=32") for o in COMMON + TEMPORAL]
    overrides += [f"data.video_frames_dir={tmp_path / 'frames'}",
                  f"system.guidance_zero123.pretrained_model_name_or_path={ckpt}",
                  "system.guidance_zero123.half_precision_weights=false",
                  "system.guidance_zero123.cond_image_size=32"]
    jt, pt, init = make_trainers("gs4d_motion", overrides, tmp_path)
    jg, pg = jt.system.guidance, pt.system.guidance
    assert pg.unet is not None and pg.denoiser is not None and jg.denoiser is not None
    np.testing.assert_allclose(pg.cond_concat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg.cond_concat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pg.cond_crossattn.numpy(), np.asarray(jg.cond_crossattn),
                               rtol=0, atol=1e-5)
    draws = jax_step_draws("gs4d_motion", jt.cfg.seed, 1,
                           guidance=(jg.sched_scalars(0), (3, 16, 16, 4)))
    pt.system.step_draws = draws.get
    call = type(pg).__call__

    def with_jax_draws(self, rgb, prompt_utils, batch, generator=None, sched=None, draws=None):
        return call(self, rgb, prompt_utils, batch, generator, sched, draws=step_draws)

    step_draws = draws[0]["guidance"]
    monkeypatch.setattr(type(pg), "__call__", with_jax_draws)
    jt.fit()
    pt.fit()
    row_j, row_p = jt.metrics_log[0], pt.metrics_log[0]
    for k in sorted(k for k in row_j if k.startswith("train/")):
        assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), k
    assert row_p["zero123/grad_norm"] > 0
    lrs = pt.system.geometry.lr_tree(0)
    want = jax.device_get(jt.state.gauss.params)
    for field in ("xyz", "features_dc", "opacity", "motion"):
        np.testing.assert_allclose(getattr(pt.state.gauss.params, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=LR_FRACTION * lrs[field], err_msg=field)


SMALL = [f"data.height=32", "data.width=32", "data.random_camera.height=32",
         "data.random_camera.width=32", "data.random_camera.batch_size=1",
         "data.random_camera.eval_height=32", "data.random_camera.eval_width=32",
         "data.random_camera.n_test_views=2", "data.random_camera.n_val_views=1",
         "data.video_length=3", "data.num_frames=3", "system.geometry.init_num_pts=64",
         "system.geometry.capacity=256", "system.renderer.tile_size=16",
         "trainer.val_check_interval=0", "trainer.log_every_n_steps=1"]


def test_deformation_trains_and_resumes(tmp_path):
    """gs4d_motion with the HexPlane deformation: its parameters are extra
    parameters with their own Adam (the zero-initialised heads' last
    biases step; their zero weights pass no gradient to the rest, as in
    the JAX package), the checkpoint carries them and the temporal fields,
    and --resume continues from it."""
    from threestudio_3dgs_tpu_torch import launch

    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gs4d_motion.yaml"
    args = ["--config", config, "--device", "cpu", "--train", f"exp_root_dir={tmp_path}",
            "system.geometry.enable_deformation=true"] + SMALL
    first = launch.main(args + ["trainer.max_steps=2"])
    extra = first.state.extra_params["deformation"]
    assert first.state.extra_opt.count == 2
    init = first.system.init_state(first.cfg.seed).extra_params["deformation"]
    assert sorted(extra) == sorted(init)
    assert not torch.equal(extra["head_pos/1/b"], init["head_pos/1/b"])
    assert torch.equal(extra["grids/0/0"], init["grids/0/0"])
    ckpt = f"{first.save_dir}/ckpts/last.ckpt.npz"
    state, step = load_checkpoint(ckpt, "cpu")
    assert step == 2 and isinstance(state.gauss.params, pst.SpacetimeParams)
    for k, v in extra.items():
        assert torch.equal(state.extra_params["deformation"][k], v), k
    for k, v in first.state.gauss.params.as_dict().items():
        assert torch.equal(getattr(state.gauss.params, k), v), k
    resumed = launch.main(["--resume", ckpt] + args + ["trainer.max_steps=3"])
    assert resumed.step == 3 and resumed.state.extra_opt.count == 3


def test_launcher_entry_points(tmp_path):
    """gs4d.yaml (spline) through the launcher on the CPU: --train (the
    timed test renders and the temporal PLY, read back equal to the alive
    rows), --test from the checkpoint with --resume, a warm start from
    the checkpoint keeping the temporal fields, and --train continued."""
    from threestudio_3dgs_tpu_torch import launch

    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gs4d.yaml"

    def run(flags, *overrides):
        return launch.main(["--config", config, "--device", "cpu"] + flags
                           + [f"exp_root_dir={tmp_path}", "system.geometry.num_frames=4"]
                           + SMALL + list(overrides))

    trained = run(["--train"], "trainer.max_steps=2")
    ply = f"{trained.save_dir}/save/point_cloud.ply"
    assert len(os.listdir(f"{trained.save_dir}/save/it2-test")) == 2
    back = pfind("spacetime-gaussian-splatting").load_temporal_ply(ply)
    g = trained.state.gauss
    for k in ("delta_xyz", "delta_rot"):
        np.testing.assert_array_equal(back[k], getattr(g.params, k)[g.alive].numpy())
    ckpt = f"{trained.save_dir}/ckpts/last.ckpt.npz"
    tested = run(["--test", "--resume", ckpt])
    assert tested.step == 2 and os.path.isdir(f"{tested.save_dir}/save/it2-test")
    warm = run(["--validate"], f"system.geometry_convert_from={ckpt}")
    for k, v in g.params.as_dict().items():
        assert torch.equal(getattr(warm.state.gauss.params, k), v), k
    resumed = run(["--train", "--resume", ckpt], "trainer.max_steps=3")
    assert resumed.step == 3 and len(resumed.metrics_log) == 1


def test_registered_name_and_static_stage_mixin():
    assert pfind("gaussian-splatting-4dgen-system") is p4d.Gaussian4DGenSystem
    from threestudio_3dgs_tpu_torch.systems.sugar_static import GaussianStageRegMixin

    assert issubclass(p4d.Gaussian4DGenSystem, GaussianStageRegMixin)


def test_4d_imports_no_jax(tmp_path):
    """In a fresh interpreter, the 4D modules and one CPU step of
    gs4d_motion.yaml through the launcher (with its test renders and
    temporal PLY) leave neither jax nor the JAX package in sys.modules."""
    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gs4d_motion.yaml"
    code = (
        "import sys\n"
        "from threestudio_3dgs_tpu_torch import launch\n"
        "from threestudio_3dgs_tpu_torch.ops import arap, lie, spline, sugar_reg\n"
        "from threestudio_3dgs_tpu_torch.models import deformation, gaussian_dynamic, spacetime\n"
        "from threestudio_3dgs_tpu_torch.renderers import spacetime as r\n"
        "from threestudio_3dgs_tpu_torch.data import temporal_image\n"
        "from threestudio_3dgs_tpu_torch.systems import gaussian_4dgen, sugar_static\n"
        f"launch.main({['--config', config, '--train', '--device', 'cpu', f'exp_root_dir={tmp_path}', 'trainer.max_steps=1'] + SMALL!r})\n"
        "bad = [m for m in ('jax', 'jaxlib', 'threestudio_3dgs_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout and "train/loss_ref_gs" in res.stdout


def test_zero123_checkpoint_that_does_not_load_raises(tmp_path):
    """A Stable Zero123 checkpoint that is there but does not load raises
    from prepare_embeddings (and so from the trainer), never a silent
    analytic prior: a file that is no torch checkpoint, and one whose
    state dict holds no ldm UNet."""
    frames = np.full((3, 32, 32, 3), 0.5, np.float32)
    corrupt, foreign = tmp_path / "corrupt.ckpt", tmp_path / "foreign.ckpt"
    corrupt.write_bytes(b"not a checkpoint")
    torch.save({"state_dict": {"encoder.weight": torch.zeros(2)}}, foreign)
    for path in (corrupt, foreign):
        g = pfind("temporal-stable-zero123-guidance")(
            {"pretrained_model_name_or_path": str(path)}, device="cpu")
        with pytest.raises(Exception):
            g.prepare_embeddings(frames)
        assert g.denoiser is None


@pytest.mark.parametrize("lacking", ["unet", "vae", "image_encoder"])
def test_zero123_directory_without_a_sub_model_raises(tmp_path, lacking):
    """A weight directory that exists but lacks ``unet/`` or ``vae/``
    weights or ``image_encoder/`` raises from prepare_embeddings, naming
    what is missing, before it reads any weights: it never leaves the
    guidance on its analytic prior."""
    for sub, name in (("unet", "diffusion_pytorch_model.bin"),
                      ("vae", "diffusion_pytorch_model.bin"),
                      ("image_encoder", "pytorch_model.bin")):
        if sub != lacking:
            os.makedirs(tmp_path / sub)
            (tmp_path / sub / name).write_bytes(b"never read")
    g = pfind("temporal-stable-zero123-guidance")(
        {"pretrained_model_name_or_path": str(tmp_path)}, device="cpu")
    with pytest.raises(FileNotFoundError, match=lacking + "/"):
        g.prepare_embeddings(np.full((2, 32, 32, 3), 0.5, np.float32))
    assert g.denoiser is None and g.unet is None


def test_zero123_path_that_does_not_exist_keeps_the_prior(tmp_path):
    """A weight path that does not exist (the YAMLs' default checkpoint in
    a checkout without ``load/``) keeps the analytic prior, as in the JAX
    package: its targets are the frames' mean colours."""
    frames = np.stack([np.full((32, 32, 3), v, np.float32) for v in (0.25, 0.75)])
    for path in (tmp_path / "absent", tmp_path / "absent.ckpt"):
        g = pfind("temporal-stable-zero123-guidance")(
            {"pretrained_model_name_or_path": str(path), "num_frames": 2}, device="cpu")
        g.prepare_embeddings(frames)
        assert g.denoiser is None and g.unet is None
        np.testing.assert_allclose(g.cond_targets.numpy(), [[0.25] * 3, [0.75] * 3])
