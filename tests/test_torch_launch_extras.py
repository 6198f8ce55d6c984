"""The launcher's ``--profile`` trace, the trainer's wandb logger and the
JAX package's last public helpers in the port, on the CPU: a profiled run
of the tiny config against the same run without the flag, the wandb calls
of both packages' trainers on a stub module, and each helper against its
JAX function on seeded numpy inputs."""

import importlib.abc
import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)
from test_torch_eval import _cli
from test_torch_train import JAX_CONFIG, JAX_ONLY, OVERRIDES

from threestudio_3dgs_tpu.models import sugar as jsugar
from threestudio_3dgs_tpu.ops import camera as jcam
from threestudio_3dgs_tpu.ops import gaussian_math as jgm
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils import loss as jloss
from threestudio_3dgs_tpu.utils import profiling as jprof
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.models import sugar as psugar
from threestudio_3dgs_tpu_torch.models.convert import sugar_state_from_numpy, to_numpy
from threestudio_3dgs_tpu_torch.ops import camera as pcam
from threestudio_3dgs_tpu_torch.ops import gaussian_math as pgm
from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
from threestudio_3dgs_tpu_torch.utils import loss as ploss
from threestudio_3dgs_tpu_torch.utils import profiling as pprof

# the host clock's keys of a metrics row; every other key is compared
CLOCK_KEYS = ("wall_s", "step_s")
WANDB_ON = "system.loggers.wandb.enable=true"


def rows_without_clock(rows):
    return [{k: v for k, v in row.items() if k not in CLOCK_KEYS} for row in rows]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny config trained TRACE_STEPS steps through the launcher
    without and with ``--profile``."""
    root = tmp_path_factory.mktemp("profile")
    plain = launch.main(_cli(root / "plain", "--train", steps=pprof.TRACE_STEPS))
    profiled = launch.main(_cli(root / "profiled", "--train", "--profile",
                                steps=pprof.TRACE_STEPS))
    return plain, profiled


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------


def test_profile_writes_a_bounded_trace(runs):
    """A TensorBoard trace under <trial_dir>/profile with the window's
    TRACE_ACTIVE profiler steps (the first step skipped, the next one the
    warm-up) and no more."""
    _, profiled = runs
    trace = pprof.read_trace(os.path.join(profiled.cfg.trial_dir, "profile"))
    assert os.path.getsize(trace["path"]) > 0 and trace["events"]
    first = pprof.TRACE_WAIT + pprof.TRACE_WARMUP
    assert trace["steps"] == [f"ProfilerStep#{i}"
                              for i in range(first, first + pprof.TRACE_ACTIVE)]
    assert trace["wall_s"] > 0
    # the CPU run records no device work
    assert trace["kernels"] == {}


def test_profile_leaves_training_unchanged(runs):
    """The profiled run's metrics rows (but their host clocks) and final
    state equal the plain run's bit for bit."""
    plain, profiled = runs
    assert len(plain.metrics_log) == pprof.TRACE_STEPS
    assert rows_without_clock(profiled.metrics_log) == rows_without_clock(plain.metrics_log)
    assert profiled.step == plain.step
    want, got = to_numpy(plain.state.gauss), to_numpy(profiled.state.gauss)
    for leaf_want, leaf_got in zip(jax.tree_util.tree_leaves(want),
                                   jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(leaf_got), np.asarray(leaf_want))


def test_profile_without_train_writes_no_trace(tmp_path):
    trainer = launch.main(_cli(tmp_path, "--test", "--profile"))
    assert not os.path.exists(os.path.join(trainer.cfg.trial_dir, "profile"))


def test_device_trace_writes_when_the_block_raises(tmp_path):
    x = torch.ones(64, 64)
    with pytest.raises(RuntimeError, match="inside the window"):
        with pprof.device_trace(str(tmp_path), device="cpu") as prof:
            for _ in range(pprof.TRACE_WAIT + pprof.TRACE_WARMUP + 1):
                x = x @ x / 64.0
                prof.step()
            raise RuntimeError("inside the window")
    trace = pprof.read_trace(str(tmp_path))
    assert trace["steps"] == [f"ProfilerStep#{pprof.TRACE_WAIT + pprof.TRACE_WARMUP}",
                              f"ProfilerStep#{pprof.TRACE_WAIT + pprof.TRACE_WARMUP + 1}"]


def test_time_fn_calls_as_jax_does():
    """The port's time_fn calls ``vary`` with the JAX one's indices and
    returns the same keys."""
    calls = {"jax": [], "port": []}

    def vary(side, array):
        def f(i):
            calls[side].append(i)
            return (array(np.full((4,), float(i), np.float32)),)
        return f

    want = jprof.time_fn(lambda x: x * 2.0, iters=3, warmup=2, vary=vary("jax", jnp.asarray))
    got = pprof.time_fn(lambda x: x * 2.0, iters=3, warmup=2, vary=vary("port", torch.tensor))
    assert calls["port"] == calls["jax"] == [0, 0, 1, 2, 3]
    assert sorted(got) == sorted(want) == ["compile_s", "ms"]
    assert got["ms"] > 0 and got["compile_s"] > 0


def test_step_timer_rows_match_jax(tmp_path):
    rows = {}
    for side, timer_cls in (("jax", jprof.StepTimer), ("port", pprof.StepTimer)):
        path = tmp_path / side / "steps.jsonl"
        timer = timer_cls(str(path))
        for step in range(3):
            timer.lap(step, loss=0.5 * step)
        timer.dump()
        rows[side] = [line for line in path.read_text().splitlines()]
        assert [r["step"] for r in timer.rows] == [0, 1, 2]
        assert all(r["ms"] >= 0 for r in timer.rows)
    strip = [[{k: v for k, v in json.loads(line).items() if k != "ms"} for line in rows[side]]
             for side in ("jax", "port")]
    assert strip[0] == strip[1]


# ---------------------------------------------------------------------------
# wandb
# ---------------------------------------------------------------------------


class StubWandb(types.ModuleType):
    """A ``wandb`` module that records ``init``, ``log`` and ``finish``."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        stub = self

        class Run:
            def log(self, row, step=None):
                stub.calls.append(("log", dict(row), step))

            def finish(self):
                stub.calls.append(("finish",))

        return Run()


@pytest.fixture
def stub_wandb(monkeypatch):
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return stub


def test_wandb_disabled_imports_nothing(tmp_path, monkeypatch):
    """With ``enable: false`` (the YAML's) no import of wandb is tried."""
    tried = []

    class Finder(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] == "wandb":
                tried.append(name)
            return None

    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    monkeypatch.setattr(sys, "meta_path", [Finder()] + sys.meta_path)
    trainer = launch.main(_cli(tmp_path, "--train"))
    assert trainer.wandb_run is None and len(trainer.metrics_log) == 2
    assert tried == []


def test_wandb_absent_is_reported_and_training_goes_on(tmp_path, monkeypatch, capsys, runs):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    trainer = launch.main(_cli(tmp_path, "--train", steps=pprof.TRACE_STEPS) + [WANDB_ON])
    assert "[trainer] wandb disabled (" in capsys.readouterr().out
    assert rows_without_clock(trainer.metrics_log) == rows_without_clock(runs[0].metrics_log)


@pytest.mark.parametrize("where", ["system", "top"])
def test_wandb_logs_every_row_on_the_stub(tmp_path, stub_wandb, where):
    """``loggers.wandb`` nested under ``system:`` (as the YAML writes it)
    or at the top level: one ``init`` with the JAX trainer's keywords, one
    ``log`` per row of metrics.jsonl with its step, one ``finish``."""
    block = (["system.loggers.wandb.enable=true"] if where == "system" else
             ["loggers={wandb: {enable: true, project: stub}}"])
    JaxTrainer(jax_load_config(JAX_CONFIG, OVERRIDES + JAX_ONLY + block
                               + [f"exp_root_dir={tmp_path / 'jax'}"]))
    (_, want), = stub_wandb.calls
    stub_wandb.calls.clear()

    trainer = launch.main(_cli(tmp_path / "port", "--train") + block)
    init, *logs, finish = stub_wandb.calls
    assert init[0] == "init" and sorted(init[1]) == sorted(want)
    assert init[1]["project"] == want["project"] == ("threestudio" if where == "system"
                                                     else "stub")
    assert init[1]["dir"] == trainer.save_dir
    assert init[1]["config"]["trial_name"] == trainer.cfg.trial_name
    with open(os.path.join(trainer.save_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [c[0] for c in logs] == ["log"] * len(rows) and len(rows) == 2
    assert [c[1] for c in logs] == rows
    assert [c[2] for c in logs] == [row["step"] for row in rows]
    assert finish == ("finish",)


def test_rank_other_than_0_neither_logs_nor_traces(tmp_path, stub_wandb, monkeypatch):
    """Rank 1 of two (the process group faked, ``trainer.devices=0`` so
    nothing is collective) trains through ``launch --train --profile``
    with wandb enabled: it calls no wandb function and writes no trace."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "barrier", lambda group=None: None)
    monkeypatch.setattr(torch.distributed, "broadcast_object_list",
                        lambda objects, src=0, group=None: None)
    trainer = launch.main(_cli(tmp_path, "--train", "--profile") + [WANDB_ON, "trainer.devices=0"])
    assert trainer.rank == 1 and trainer.wandb_run is None
    assert len(trainer.metrics_log) == trainer.max_steps == 2
    assert stub_wandb.calls == []
    assert not os.path.exists(os.path.join(trainer.cfg.trial_dir, "profile"))


# ---------------------------------------------------------------------------
# The public helpers
# ---------------------------------------------------------------------------


def _pair(rng, shape):
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss", "pearson_correlation"])
def test_losses_match_jax(name):
    """f32 means over 2 x 16 x 16 x 3 values: 1e-6 relative; pearson's
    inputs correlated (b = 0.6 a + noise) so the value is far from 0."""
    a, noise = _pair(np.random.default_rng(0), (2, 16, 16, 3))
    b = 0.6 * a + noise
    want = float(getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(ploss, name)(torch.tensor(a), torch.tensor(b)))
    assert got == pytest.approx(want, rel=1e-6)


def test_fov_focal_match_jax():
    fovs = np.deg2rad(np.array([20.0, 40.0, 49.1, 70.0], np.float32))
    for fov in fovs:
        np.testing.assert_allclose(float(pcam.fov_to_focal(float(fov), 512)),
                                   float(jcam.fov_to_focal(fov, 512)), rtol=1e-6)
    focal = pcam.fov_to_focal(torch.tensor(fovs), 512.0)
    np.testing.assert_allclose(focal.numpy(), np.asarray(jcam.fov_to_focal(jnp.asarray(fovs), 512.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(pcam.focal_to_fov(focal, 512.0).numpy(),
                               np.asarray(jcam.focal_to_fov(jnp.asarray(focal.numpy()), 512.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(pcam.focal_to_fov(focal, 512.0).numpy(), fovs, rtol=1e-6)


@pytest.mark.parametrize("use_pixel_center", [True, False])
def test_ray_directions_match_jax(use_pixel_center):
    """A 12 x 20 grid at fovy 0.7: 1e-6 absolute (f32 divisions of pixel
    offsets by one focal)."""
    want = np.asarray(jcam.get_ray_directions(12, 20, 0.7, use_pixel_center))
    got = pcam.get_ray_directions(12, 20, 0.7, use_pixel_center, device="cpu")
    assert got.shape == (12, 20, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _c2ws(rng, n):
    """n random rigid OpenGL c2w matrices."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(size=3)
        out[i, 3, 3] = 1.0
    return out


@pytest.mark.parametrize("keepdim", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_rays_match_jax(keepdim, normalize, batched):
    """One camera on (H, W, 3) directions, or 3 cameras on (3, H, W, 3):
    origins equal, directions to 1e-6."""
    rng = np.random.default_rng(1)
    dirs = np.asarray(jcam.get_ray_directions(6, 8, 0.9))
    c2w = _c2ws(rng, 3)
    if batched:
        dirs = np.stack([dirs] * 3)
    else:
        c2w = c2w[0]
    want = jcam.get_rays(jnp.asarray(dirs), jnp.asarray(c2w), keepdim, normalize)
    got = pcam.get_rays(torch.tensor(dirs), torch.tensor(c2w), keepdim, normalize)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_mvp_matrix_matches_jax():
    """proj @ w2c of a random c2w with the JAX package's projection: 1e-5
    relative (a 4x4 product in f32)."""
    c2w = _c2ws(np.random.default_rng(2), 1)[0]
    proj = np.asarray(jcam.projection_matrix(0.1, 100.0, jnp.float32(0.8), jnp.float32(0.6)))
    want = np.asarray(jcam.get_mvp_matrix(jnp.asarray(c2w), jnp.asarray(proj)))
    got = pcam.get_mvp_matrix(torch.tensor(c2w), torch.tensor(proj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unstrip_symmetric_matches_jax():
    cov6 = np.random.default_rng(3).normal(size=(5, 7, 6)).astype(np.float32)
    want = np.asarray(jgm.unstrip_symmetric(jnp.asarray(cov6)))
    got = pgm.unstrip_symmetric(torch.tensor(cov6))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pgm.strip_symmetric(got).numpy(), cov6)


def test_gaussian_3d_coeff_matches_jax():
    """Densities of 200 offsets under covariances from random scales and
    rotations, and under indefinite ones (a positive exponent: 0): 1e-5
    relative, 1e-7 absolute (exponents of f32 closed-form inverses)."""
    rng = np.random.default_rng(5)
    n = 200
    scales = np.exp(rng.normal(size=(n, 3)) * 0.5 - 1.0).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    cov6 = np.array(jgm.strip_symmetric(jgm.covariance_from_scaling_rotation(
        jnp.asarray(scales), jnp.asarray(quats))))
    cov6[:20] = rng.normal(size=(20, 6)).astype(np.float32)  # not positive definite
    xyz = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jgm.gaussian_3d_coeff(jnp.asarray(xyz), jnp.asarray(cov6)))
    got = pgm.gaussian_3d_coeff(torch.tensor(xyz), torch.tensor(cov6)).numpy()
    assert (want[:20] == 0).any() and (want[20:] > 1e-3).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_save_mesh_obj_bytes_match_jax(tmp_path):
    """The SuGaR mesh with moved vertices (a trained state's) written by
    both packages: the same bytes."""
    verts, faces = icosphere()
    cfg = {"n_gaussians_per_surface_triangle": 6}
    jm, pm = jsugar.SuGaRModel(dict(cfg)), psugar.SuGaRModel(dict(cfg), device="cpu")
    jm.bind_mesh(verts, faces)
    pm.bind_mesh(verts, faces)
    jstate = jm.init_state(0)
    noise = np.random.default_rng(6).normal(size=verts.shape).astype(np.float32) * 0.01
    jstate = jstate.replace(params=jstate.params.replace(points=jstate.params.points + noise))
    pstate = sugar_state_from_numpy(jax.device_get(jstate), device="cpu")
    jm.save_mesh_obj(jstate, str(tmp_path / "jax.obj"))
    pm.save_mesh_obj(pstate, str(tmp_path / "port.obj"))
    want = (tmp_path / "jax.obj").read_bytes()
    assert sum(line.startswith(b"f ") for line in want.splitlines()) == len(faces)
    assert (tmp_path / "port.obj").read_bytes() == want
