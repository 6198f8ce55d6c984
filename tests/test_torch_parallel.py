"""The port's multi-device layer (``threestudio_3dgs_tpu_torch/parallel/``)
against the JAX package's on the CPU, case by case as tests/test_parallel.py
holds the JAX package: the camera-sharded dp step against the JAX dp step
and the one-process step, its determinism, a local batch above 1 on the
single pass, the tile-sharded renderer's outputs and gradients, the
trainer's routing (auto, ``devices=1``, a gcd sub-group), the dp loss
against the one-process loss, the capacity controller under an oscillating
demand, and the chunked gradient mean against one collective a leaf.

The port runs 4 gloo ranks, spawned once for the file (a module fixture
that returns every case's results, tests/torch_dist_worker.py); the JAX
side runs in this process on a 4-device sub-mesh of the conftest's 8
virtual CPU devices, its state carried across through models/convert.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from test_torch_train import PARAM_ATOL, PORT_CONFIG  # also shares the CPU threads
from threestudio_3dgs_tpu.data.uncond import RandomCameraDataModuleConfig, RandomCameraSampler
from threestudio_3dgs_tpu.ops import camera as jcam
from threestudio_3dgs_tpu.ops.rasterizer import RasterizeConfig as JConfig
from threestudio_3dgs_tpu.parallel import data_parallel as jdp
from threestudio_3dgs_tpu.parallel.tile_parallel import make_tile_parallel_rasterize
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.ops import camera as cam_ops
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from threestudio_3dgs_tpu_torch.systems.base import BaseGaussianSystem, SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.ckpt import save_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from torch_dist_worker import spawn_ranks

WORLD = 4
BS = 8  # 4 ranks x 2 views: each rank's shard takes the single pass
# tests/test_parallel.py's system (fake-mse guidance: no draw in the loss)
SYSTEM = {
    "geometry": {"init_num_pts": 256, "max_num": 1024, "capacity": 1024},
    "renderer_type": "diff-gaussian-rasterizer-advanced",
    "renderer": {"tile_size": 16, "max_pairs": 16384},
    "guidance_type": "fake-mse-guidance",
    "guidance": {"target_color": [0.8, 0.2, 0.2]},
    "loss": {"lambda_sds": 1.0, "lambda_position": 0.1},
}
JAX_SYSTEM = dict(SYSTEM, renderer=dict(SYSTEM["renderer"], impl="jax"))
# tests/test_parallel.py's trainer overrides
TRAIN = [
    "trainer.max_steps=2", "data.width=32", "data.height=32",
    "system.geometry.init_num_pts=128", "system.geometry.max_num=512",
    "system.geometry.capacity=512", "system.renderer.tile_size=16",
    "system.renderer.max_pairs=16384", "system.guidance_type=fake-sds-guidance",
]
MSE_1STEP = ["trainer.max_steps=1", "system.guidance_type=fake-mse-guidance"]


def tile_scene(n, seed):
    """tests/test_parallel.py's tile-parallel scene and 128^2 camera."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 3.6)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, size=(n,)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    eye = np.array([0.0, -2.5, 0.5])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return (means, scales, quats, opac, cols), c2w


TILE_FWD = dict(scene=tile_scene(3000, 0), bg=[0.1, 0.2, 0.3], max_pairs=32768)
TILE_GRAD = dict(scene=tile_scene(1500, 3), bg=[0.0, 0.0, 0.0], max_pairs=16384)


def chunk_trees():
    """Leaves below and above the chunking threshold: exactly representable
    values (integers / 256, whose sums are exact in any order, so chunked
    and plain must agree bit for bit) and standard normal ones."""
    rng = np.random.default_rng(0)
    shapes = {"xyz": (1000, 3), "rest": (1000, 15, 3), "small": (7,), "big": (40000, 3)}
    exact = {k: (rng.integers(-2**12, 2**12, size=s) / 256).astype(np.float32)
             for k, s in shapes.items()}
    normal = {k: rng.normal(size=s).astype(np.float32) * (1e3 if k == "xyz" else 1.0)
              for k, s in shapes.items()}
    return {"exact": exact, "normal": normal}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_side")
    system = jfind("gaussian-splatting-system")(JAX_SYSTEM)
    sampler = RandomCameraSampler(RandomCameraDataModuleConfig(batch_size=BS, height=32,
                                                               width=32))
    batch = sampler.sample()
    state = system.init_state(0)
    ckpt = str(root / "init.ckpt.npz")
    save_checkpoint(ckpt, SystemState(gauss=gaussian_state_from_numpy(
        jax.device_get(state.gauss), device="cpu")), 0)
    mesh4 = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    step = jdp.make_dp_train_step(system, mesh4, 32, 32, BS)
    s_dp, logs_dp = step(state, jdp.shard_batch(mesh4, to_device_batch(batch)),
                         jax.random.PRNGKey(0), system.sched_scalars(0))
    out = dict(batch=batch, ckpt=ckpt, init=jax.device_get(state.gauss),
               dp=jax.device_get(s_dp.gauss), dp_logs=jax.device_get(logs_dp))

    # the tile-sharded renderer on a 4-device "tile" mesh
    tile_mesh = Mesh(np.array(jax.devices()[:WORLD]), ("tile",))
    for name, case, grads in (("tile_fwd", TILE_FWD, False), ("tile_grad", TILE_GRAD, True)):
        args = tuple(map(jnp.asarray, case["scene"][0]))
        cam = jcam.camera_from_c2w(jnp.asarray(case["scene"][1]), 0.9, 0.9, 128, 128)
        cfg = JConfig(tile_size=16, max_pairs=case["max_pairs"], impl="jax")
        f = make_tile_parallel_rasterize(tile_mesh, "tile", cam, jnp.asarray(case["bg"]),
                                         config=cfg)
        if grads:
            def loss(*a):
                o = f(*a)
                return jnp.sum(o["image"] ** 2) + 0.2 * jnp.sum(o["alpha"])

            out[name] = [np.asarray(g) for g in
                         jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)]
        else:
            out[name] = jax.device_get(jax.jit(f)(*args))

    # the chunked mean over 4 devices, device i holding (i + 1) x the tree
    out["chunked"] = {}
    for name, tree in chunk_trees().items():
        stacked = {k: jnp.concatenate([jnp.asarray(v) * (i + 1) for i in range(WORLD)])
                   for k, v in tree.items()}
        body = jax.shard_map(lambda t: jdp.chunked_pmean(t, "data", chunks=4), mesh=mesh4,
                             in_specs=(P("data"),), out_specs=P(), check_vma=False)
        out["chunked"][name] = jax.device_get(jax.jit(body)(stacked))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every port case in one spawn of 4 gloo ranks."""
    root = tmp_path_factory.mktemp("ranks")
    batch, ckpt = jax_side["batch"], jax_side["ckpt"]
    tile = {name: dict(scene=list(case["scene"][0]), c2w=case["scene"][1], fov=0.9, size=128,
                       bg=case["bg"], tile_size=16, max_pairs=case["max_pairs"])
            for name, case in (("tile_fwd", TILE_FWD), ("tile_grad", TILE_GRAD))}

    def train(name, extra):
        return (name, "train", dict(config=PORT_CONFIG,
                                    overrides=TRAIN + extra + [f"exp_root_dir={root / name}"]))

    cases = [
        ("dp", "dp_step", dict(system_cfg=SYSTEM, ckpt=ckpt, batch=batch, repeats=2)),
        ("dp_1chunk", "dp_step", dict(system_cfg=SYSTEM, ckpt=ckpt, batch=batch, chunks=1)),
        ("one_process", "one_process_step", dict(system_cfg=SYSTEM, ckpt=ckpt, batch=batch)),
        ("tile_fwd", "tile_render", tile["tile_fwd"]),
        ("tile_grad", "tile_render", dict(tile["tile_grad"], grads=True)),
        ("chunked", "chunked_vs_plain", dict(trees=chunk_trees())),
        train("auto", ["data.batch_size=4"]),
        train("gcd", ["data.batch_size=6"]),
        train("loss_dp", ["data.batch_size=4"] + MSE_1STEP),
        train("loss_one", ["data.batch_size=4", "trainer.devices=0"] + MSE_1STEP),
    ]
    return spawn_ranks(WORLD, cases, str(root))


def rel_err(a, b):
    return float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) + 1e-12)


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------


class TestDataParallel:
    def test_dp_matches_jax_dp(self, jax_side, ranks):
        """The port's 4-rank step against the JAX package's 4-device step:
        logs, parameters (test_torch_train's tolerances) and statistics."""
        got = ranks[0]["dp"]["runs"][0]
        want = jax_side["dp"]
        logs = jax_side["dp_logs"]
        assert got["logs"]["train/loss_total"] == pytest.approx(
            float(logs["train/loss_total"]), rel=1e-4)
        for k in ("n_pairs_max", "n_dropped_pairs"):
            assert got["logs"][k] == int(logs[k]), k
        for field, atol in PARAM_ATOL.items():
            want_field = np.asarray(getattr(want.params, field))
            np.testing.assert_allclose(got["state"][field], want_field, rtol=0, atol=atol,
                                       err_msg=field)
        np.testing.assert_array_equal(got["state"]["max_radii2d"], np.asarray(want.max_radii2d))
        np.testing.assert_array_equal(got["state"]["denom"], np.asarray(want.denom))
        accum = np.asarray(want.xyz_grad_accum)
        assert accum.max() > 0
        np.testing.assert_allclose(got["state"]["xyz_grad_accum"], accum, rtol=0,
                                   atol=1e-5 * accum.max())

    def test_dp_matches_single_device(self, jax_side, ranks):
        """tests/test_parallel.py's check on the port: the dp step and the
        one-process step both move the field, by the same first Adam step,
        and (deterministic mse guidance) at the same loss."""
        dp, single = ranks[0]["dp"]["runs"][0], ranks[0]["one_process"]
        init = np.asarray(jax_side["init"].params.xyz)
        d_dp = np.abs(dp["state"]["xyz"] - init).max()
        d_single = np.abs(single["state"]["xyz"] - init).max()
        assert d_dp > 0 and d_single > 0
        np.testing.assert_allclose(d_dp, d_single, rtol=0.2)
        assert dp["logs"]["train/loss_total"] == pytest.approx(
            single["logs"]["train/loss_total"], rel=2e-4)

    def test_dp_ranks_replicated(self, ranks):
        """Every rank ends the step with the same field, bit for bit."""
        want = ranks[0]["dp"]["runs"][0]
        for r in range(1, WORLD):
            got = ranks[r]["dp"]["runs"][0]
            assert got["logs"] == want["logs"]
            for k, v in want["state"].items():
                np.testing.assert_array_equal(got["state"][k], v, err_msg=f"rank {r} {k}")

    def test_dp_local_batch_gt1_uses_batched_renderer(self, ranks):
        """2 views a rank: each rank's shard takes the single pass."""
        for r in range(WORLD):
            assert ranks[r]["dp"]["runs"][0]["paths"] == {("batched", True): 1}
            assert np.isfinite(ranks[r]["dp"]["runs"][0]["logs"]["train/loss_total"])

    def test_dp_grad_determinism(self, ranks):
        a, b = ranks[0]["dp"]["runs"]
        for k, v in a["state"].items():
            np.testing.assert_array_equal(b["state"][k], v, err_msg=k)


class TestTileParallel:
    """Tile-row bands over 4 ranks: the gathered view equals the one-rank
    render and the JAX package's sharded render; the bands' summed
    gradients equal the full render's."""

    def _single(self, case, grads=False):
        scene, c2w = case["scene"]
        xs = [torch.tensor(a, requires_grad=grads) for a in scene]
        cam = cam_ops.camera_from_c2w(c2w, 0.9, 0.9, 128, 128, device="cpu")
        out = rasterize(*xs[:4], cam, torch.tensor(case["bg"]), colors=xs[4], with_depth=True,
                        config=RasterizeConfig(tile_size=16, max_pairs=case["max_pairs"]))
        if not grads:
            return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in out.items()}
        loss = torch.sum(out["image"] ** 2) + 0.2 * torch.sum(out["alpha"])
        return [g.numpy() for g in torch.autograd.grad(loss, xs)]

    def test_tile_parallel_matches_single(self, jax_side, ranks):
        ref = self._single(TILE_FWD)
        jref = jax_side["tile_fwd"]
        for r in range(WORLD):
            out = ranks[r]["tile_fwd"]
            assert out["band_image"].shape == (128 // WORLD, 128, 3)
            for want in (ref, jref):
                # band-space pixel math reassociates a few f32 ops (the
                # JAX test measured 2.3e-6)
                np.testing.assert_allclose(out["image"], np.asarray(want["image"]), atol=1e-5)
                np.testing.assert_allclose(out["alpha"], np.asarray(want["alpha"]), atol=1e-5)
                np.testing.assert_allclose(out["depth"], np.asarray(want["depth"]), atol=1e-4)
                np.testing.assert_array_equal(out["radii"], np.asarray(want["radii"]))
                np.testing.assert_array_equal(out["visibility"], np.asarray(want["visibility"]))
            assert out["n_dropped"] == 0

    def test_tile_parallel_grads_psum(self, jax_side, ranks):
        ref = self._single(TILE_GRAD, grads=True)
        names = ["means", "scales", "quats", "opac", "cols"]
        for r in range(WORLD):
            for name, got, want, jwant in zip(names, ranks[r]["tile_grad"]["grads"], ref,
                                              jax_side["tile_grad"]):
                assert rel_err(got, want) < 1e-3, (r, name, rel_err(got, want))
                assert rel_err(got, jwant) < 1e-3, (r, name, rel_err(got, jwant))


class TestTrainerDataParallel:
    """The trainer engages the camera-sharded step on a multi-rank group."""

    def test_trainer_auto_engages_mesh(self, ranks):
        for r in range(WORLD):
            res = ranks[r]["auto"]
            assert res["mesh_size"] == WORLD and res["system_mesh_is_trainer_mesh"]
            assert res["dp_steps"] == [("dp", WORLD, 4)]
            assert res["digest"] == ranks[0]["auto"]["digest"]
            assert len(res["metrics"]) == 2
            # rank 0 alone writes: one line a step, whichever ranks share the directory
            assert res.get("metrics_lines", 2) == 2

    def test_trainer_gcd_sub_group(self, ranks):
        """bs = 6 on 4 ranks: gcd 2 ranks hold shards, 2 step a copy with
        zero weight, and all 4 end with the same state."""
        for r in range(WORLD):
            assert ranks[r]["gcd"]["dp_steps"] == [("dp", 2, 6)]
            assert ranks[r]["gcd"]["digest"] == ranks[0]["gcd"]["digest"]
        assert ranks[0]["gcd"]["metrics"][-1]["train/loss_total"] == ranks[3]["gcd"]["metrics"][
            -1]["train/loss_total"]

    def test_trainer_dp_loss_matches_single_device(self, ranks):
        """Same seed, same data, deterministic mse guidance: the dp
        trainer's first-step loss equals the one-process trainer's."""
        loss_dp = ranks[0]["loss_dp"]["metrics"][0]["train/loss_total"]
        loss_one = ranks[0]["loss_one"]["metrics"][0]["train/loss_total"]
        assert ranks[0]["loss_dp"]["dp_steps"] == [("dp", WORLD, 4)]
        assert ranks[0]["loss_one"]["dp_steps"] == [] and ranks[0]["loss_one"]["mesh_size"] is None
        np.testing.assert_allclose(loss_dp, loss_one, rtol=2e-4)

    def test_trainer_devices_one_forces_1dev_mesh(self, tmp_path):
        """trainer.devices=1 without a group: a one-rank gloo group, the dp
        step on it, and the one-process step's state bit for bit."""
        def run(name, devices):
            cfg = load_config(PORT_CONFIG, TRAIN + [
                "data.batch_size=4", f"trainer.devices={devices}",
                f"exp_root_dir={tmp_path / name}"])
            tr = Trainer(cfg, device="cpu")
            try:
                tr.fit()
                return tr.mesh, sorted(tr.system._dp_steps), tr.state.gauss
            finally:
                tr.close()

        mesh, steps, dp = run("one", 1)
        assert mesh is not None and mesh.size() == 1 and steps == [("dp", 1, 4)]
        assert not torch.distributed.is_initialized()
        mesh0, steps0, plain = run("zero", 0)
        assert mesh0 is None and steps0 == []
        for k, v in plain.params.as_dict().items():
            assert torch.equal(getattr(dp.params, k), v), k
        for k in ("max_radii2d", "xyz_grad_accum", "denom"):
            assert torch.equal(getattr(dp, k), getattr(plain, k)), k

    def test_trainer_devices_must_match_world(self, tmp_path):
        cfg = load_config(PORT_CONFIG, TRAIN + ["trainer.devices=2",
                                                f"exp_root_dir={tmp_path}"])
        with pytest.raises(ValueError, match="trainer.devices=2"):
            Trainer(cfg, device="cpu")


class TestAdaptiveCapacityThrash:
    """tests/test_parallel.py's controller cases on the port's controller:
    growth is immediate, shrinks obey the cooldown."""

    def _harness(self, max_pairs=4 * 1024 * 1024, min_pairs=256 * 1024):
        class _RCfg:
            adaptive_max_pairs = True

        _RCfg.max_pairs, _RCfg.min_pairs = max_pairs, min_pairs

        class _H:
            _ADAPT_EVERY = BaseGaussianSystem._ADAPT_EVERY
            _BUCKET = BaseGaussianSystem._BUCKET
            _SHRINK_COOLDOWN = BaseGaussianSystem._SHRINK_COOLDOWN
            _adapt_pair_capacity = BaseGaussianSystem._adapt_pair_capacity

            class renderer:
                cfg = _RCfg()

        h = _H()
        h._capacity = max_pairs
        h._pair_log = []
        h._retrace_count = 0
        h._last_shrink_step = -(10**9)
        return h

    def test_oscillating_demand_bounded_retraces(self, capsys):
        h = self._harness()
        every = h._ADAPT_EVERY
        caps = []
        for i in range(1, 41):
            h._pair_log.append((300_000 if i % 2 else 2_500_000, 0))
            h._adapt_pair_capacity(i * every)
            caps.append(h._capacity)
        n_windows = 40 * every // h._SHRINK_COOLDOWN
        assert h._retrace_count <= 2 * n_windows + 2, (h._retrace_count, caps)

    def test_growth_is_immediate_on_drops(self, capsys):
        h = self._harness()
        h._capacity = 512 * 1024
        h._pair_log.append((900_000, 400_000))
        h._adapt_pair_capacity(h._ADAPT_EVERY)
        assert h._capacity > 512 * 1024
        assert h._retrace_count == 1

    def test_steady_state_no_retrace(self):
        h = self._harness()
        h._capacity = 1024 * 1024
        for i in range(1, 11):
            h._pair_log.append((600_000, 0))
            h._adapt_pair_capacity(i * h._ADAPT_EVERY)
        assert h._retrace_count == 0
        assert h._capacity == 1024 * 1024


class TestChunkedPsum:
    def test_chunked_matches_plain(self, jax_side, ranks):
        """Chunked == one collective a leaf, bit for bit where every sum is
        exact (the reduction order inside gloo may change with the message
        size, so on standard normal values 1e-6 relative), and == the JAX
        package's chunked pmean to 1e-6 relative."""
        for r in range(WORLD):
            res = ranks[r]["chunked"]
            for k, v in res["exact"]["plain"].items():
                np.testing.assert_array_equal(res["exact"]["chunked"][k], v, err_msg=k)
            for k, v in res["normal"]["plain"].items():
                np.testing.assert_allclose(res["normal"]["chunked"][k], v, rtol=1e-6, err_msg=k)
        for name in ("exact", "normal"):
            for k, v in ranks[0]["chunked"][name]["chunked"].items():
                np.testing.assert_allclose(v, np.asarray(jax_side["chunked"][name][k]),
                                           rtol=1e-6, err_msg=f"{name} {k}")

    def test_dp_step_unchanged_with_chunks(self, ranks):
        four, one = ranks[0]["dp"]["runs"][0], ranks[0]["dp_1chunk"]["runs"][0]
        np.testing.assert_allclose(four["state"]["xyz"], one["state"]["xyz"], atol=1e-6)
        assert four["logs"]["train/loss_total"] == pytest.approx(
            one["logs"]["train/loss_total"], rel=1e-5)
