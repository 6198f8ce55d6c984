"""The port trainer's failure handling, mirroring tests/test_fault_tolerance.py
for the JAX package: a failed step writes ckpts/crash.ckpt.npz and is
retried up to max_retries times, then re-raised; programming errors and
hand-kernel failures (``ops.native.KernelError``) are raised at once and
never retried; the NaN watchdog aborts with a checkpoint.  The crash
checkpoint of a config with a neural background loads back with its
background MLP and Adam state."""

import os

import numpy as np
import pytest
import torch

from threestudio_3dgs_tpu_torch.ops.native import KernelError
from threestudio_3dgs_tpu_torch.systems.base import flatten_extra
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config

from test_torch_train import PORT_CONFIG, ROOT

SHADING = os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs",
                       "gaussian_splatting_shading.yaml")
OVERRIDES = [
    "trainer.max_steps=4",
    "trainer.log_every_n_steps=1",
    "trainer.val_check_interval=0",
    "data.width=32",
    "data.height=32",
    "data.batch_size=1",
    "system.geometry.init_num_pts=64",
    "system.geometry.capacity=128",
    "system.renderer.tile_size=16",
    "system.renderer.max_pairs=8192",
    "system.guidance_type=fake-sds-guidance",
    "checkpoint.every_n_train_steps=100",
]


def _make_trainer(tmp_path, extra=(), config=PORT_CONFIG):
    cfg = load_config(config, list(OVERRIDES) + [f"exp_root_dir={tmp_path}"] + list(extra))
    return Trainer(cfg, device="cpu")


def _flaky(trainer, fail_on, error):
    """Make the system's train_step raise ``error`` on the given calls."""
    real_step = trainer.system.train_step
    calls = {"n": 0}

    def step(state, batch, step, generator):
        calls["n"] += 1
        if calls["n"] in fail_on:
            raise error
        return real_step(state, batch, step, generator)

    trainer.system.train_step = step
    return calls


def test_transient_fault_retries_and_recovers(tmp_path):
    trainer = _make_trainer(
        tmp_path, ["trainer.fault_tolerance={max_retries: 2, retry_wait_s: 0}"])
    calls = _flaky(trainer, {2}, RuntimeError("injected device fault"))
    trainer.fit()
    assert trainer.step == 4 and calls["n"] == 5  # all steps done despite the fault
    assert [row["step"] for row in trainer.metrics_log] == [1, 2, 3, 4]
    assert os.path.exists(os.path.join(trainer.save_dir, "ckpts", "crash.ckpt.npz"))


def test_fault_exhausts_retries(tmp_path):
    trainer = _make_trainer(
        tmp_path, ["trainer.fault_tolerance={max_retries: 1, retry_wait_s: 0}"])
    calls = _flaky(trainer, set(range(1, 10)), RuntimeError("persistent device fault"))
    with pytest.raises(RuntimeError, match="persistent device fault"):
        trainer.fit()
    assert calls["n"] == 2  # the first try and one retry


def test_default_retry_settings(tmp_path):
    """max_retries 1 and retry_wait_s 10, as in the JAX trainer."""
    trainer = _make_trainer(tmp_path)
    settings = (trainer.ft_max_retries, trainer.ft_retry_wait_s, trainer.ft_nan_patience)
    assert settings == (1, 10.0, 3)


@pytest.mark.parametrize("error", [
    TypeError("t"), ValueError("v"), AttributeError("a"), KeyError("k"), IndexError("i"),
    AssertionError("assert"),
    KernelError("blend_forward: CUDA error 700 (cudaErrorIllegalAddress)"),
], ids=lambda e: type(e).__name__)
def test_not_retried(tmp_path, error):
    """Programming errors and a hand kernel's build or launch failure are
    raised at once: no retry, no wait, no crash checkpoint."""
    trainer = _make_trainer(
        tmp_path, ["trainer.fault_tolerance={max_retries: 5, retry_wait_s: 100}"])
    calls = _flaky(trainer, {1}, error)
    with pytest.raises(type(error)):
        trainer.fit()
    assert calls["n"] == 1
    assert not os.path.exists(os.path.join(trainer.save_dir, "ckpts", "crash.ckpt.npz"))


def test_kernel_error_is_a_runtime_error_raised_by_native():
    """KernelError subclasses RuntimeError (callers that catch the launch
    error keep working) and is what a failed nvcc lookup raises."""
    from threestudio_3dgs_tpu_torch.ops import native

    assert issubclass(KernelError, RuntimeError)
    old = os.environ.get("CUDA_HOME")
    os.environ["CUDA_HOME"] = "/no/such/cuda"
    try:
        if native.shutil.which("nvcc") is None:
            with pytest.raises(KernelError, match="nvcc not found"):
                native.nvcc_path()
    finally:
        if old is None:
            os.environ.pop("CUDA_HOME")
        else:
            os.environ["CUDA_HOME"] = old


def test_nan_watchdog_aborts(tmp_path):
    trainer = _make_trainer(tmp_path, ["trainer.fault_tolerance={nan_patience: 2}"])
    real_step = trainer.system.train_step

    def nan_step(state, batch, step, generator):
        state, logs = real_step(state, batch, step, generator)
        logs = dict(logs)
        logs["train/loss_total"] = torch.tensor(float("nan"))
        return state, logs

    trainer.system.train_step = nan_step
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.fit()
    assert os.path.exists(os.path.join(trainer.save_dir, "ckpts", "nan.ckpt.npz"))


def test_crash_checkpoint_loads_back_with_extra_params(tmp_path):
    """The shading YAML's neural background: after two good steps a fault
    saves the state the failed step started from, background MLP and its
    Adam state included, and --resume's loader reads it back."""
    trainer = _make_trainer(
        tmp_path, ["trainer.fault_tolerance={max_retries: 0, retry_wait_s: 0}",
                   "system.renderer.adaptive_max_pairs=false"], config=SHADING)
    _flaky(trainer, {3}, RuntimeError("injected device fault"))
    with pytest.raises(RuntimeError, match="injected"):
        trainer.fit()
    state, step = load_checkpoint(
        os.path.join(trainer.save_dir, "ckpts", "crash.ckpt.npz"), device="cpu")
    assert step == trainer.step == 2
    assert state.extra_opt.count == 2 == trainer.state.extra_opt.count
    want = flatten_extra(trainer.state.extra_params)
    got = flatten_extra(state.extra_params)
    assert set(got) == set(want) == {f"background/{k}{i}" for k in "wb" for i in range(3)}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        np.testing.assert_array_equal(state.extra_opt.mu[k].numpy(),
                                      trainer.state.extra_opt.mu[k].numpy())
    np.testing.assert_array_equal(state.gauss.params.xyz.numpy(),
                                  trainer.state.gauss.params.xyz.numpy())
    resumed = _make_trainer(tmp_path / "resume", ["trainer.max_steps=3"], config=SHADING)
    resumed.fit(resume=os.path.join(trainer.save_dir, "ckpts", "crash.ckpt.npz"))
    assert resumed.step == 3 and resumed.state.extra_opt.count == 3
