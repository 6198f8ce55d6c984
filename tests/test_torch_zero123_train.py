"""The port's image-to-3D system (threestudio_3dgs_tpu_torch.systems.
gaussian_zero123) against the JAX package on the CPU: the masked depth
losses with their gradients, and 3 training steps of
gaussian_splatting_zero123.yaml at 32^2 in both packages (the synthetic
reference; a real RGBA PNG with depth and normal maps, the normal renderer
and every reference loss on), held as tests/test_torch_train.py holds
steps."""

import fcntl
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_train import JAX_ONLY, ROOT

from threestudio_3dgs_tpu.systems import gaussian_zero123 as jz
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.systems import gaussian_zero123 as pz
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind


def depth_inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1, 3, (1, 16, 16, 1)).astype(np.float32)
    gt = (0.7 * pred + 0.2 + 0.05 * rng.normal(size=pred.shape)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.3).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize("name", ["masked_depth_align_loss", "masked_pearson"])
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_depth_losses_match_jax(name, seed):
    """The aligned-depth MSE (a and b without gradient) and the masked
    Pearson correlation: values and gradients w.r.t. the predicted depth,
    f32 summation order only (1e-5 relative)."""
    pred, gt, mask = depth_inputs(seed)
    jfn, pfn = getattr(jz, name), getattr(pz, name)
    want, want_grad = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(gt), jnp.asarray(mask)))(
        jnp.asarray(pred))
    x = torch.tensor(pred, requires_grad=True)
    got = pfn(x, torch.tensor(gt), torch.tensor(mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_grad).max()))


def test_registered_name():
    assert pfind("gaussian-splatting-zero123-system") is pz.Zero123System


STEPS = 3
# 32^2 for the reference and the random views (one size each: a JAX compile
# per resolution), tile 16, 256 points in a 1536 field, min_step_percent ==
# max_step_percent so the analytic prior's noise cancels from its target
COMMON = [
    f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0",
    "data.height=32", "data.width=32", "data.random_camera.height=32",
    "data.random_camera.width=32", "data.random_camera.batch_size=2",
    "system.geometry.init_num_pts=256", "system.geometry.capacity=1536",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.batched=false", "system.renderer.adaptive_max_pairs=false",
    "system.guidance.min_step_percent=0.5", "system.guidance.max_step_percent=0.5",
]
MAPS = ["system.renderer_type=diff-gaussian-rasterizer-normal",
        "system.loss.lambda_depth=0.5", "system.loss.lambda_depth_rel=0.5",
        "system.loss.lambda_normal=0.5", "system.loss.lambda_normal_smooth=0.5"]
LR_FRACTION = 0.02
FIELDS = ("xyz", "features_dc", "scaling", "opacity")


def write_reference(root):
    """A 48^2 RGBA disc (shrunk to 32^2 by the loaders) with 8-bit depth and
    normal maps beside it."""
    path = root / "thing_rgba.png"
    yy, xx = np.mgrid[0:48, 0:48] / 47.0 * 2 - 1
    rng = np.random.default_rng(4)
    alpha = ((xx**2 + yy**2) < 0.4).astype(np.uint8) * 255
    rgb = (np.stack([0.5 + 0.4 * xx, 0.5 + 0.4 * yy, 0.3 + 0 * xx], -1) * 255).astype(np.uint8)
    Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1), "RGBA").save(path)
    depth = ((1.5 - 0.5 * np.sqrt(np.clip(0.4 - xx**2 - yy**2, 0, 1))) * 100).astype(np.uint8)
    Image.fromarray(depth).save(root / "thing_depth.png")
    normal = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    Image.fromarray(normal).save(root / "thing_normal.png")
    return str(path)


def train_both(name, root):
    """Both packages trained STEPS steps of the zero123 YAML from the JAX
    package's initial state: their logs, initial and final fields (the
    parameters and densification statistics) and learning rates."""
    extra = (["data.image_path="] if name == "synthetic"
             else [f"data.image_path={write_reference(root)}"] + MAPS)
    overrides = COMMON + extra
    yaml = "gaussian_splatting_zero123.yaml"
    jt = JaxTrainer(jax_load_config(f"{ROOT}/threestudio_3dgs_tpu/configs/{yaml}",
                                    overrides + JAX_ONLY + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(f"{ROOT}/threestudio_3dgs_tpu_torch/configs/{yaml}",
                             overrides + [f"exp_root_dir={root / 'port'}"]), device="cpu")
    jt.state = jt.system.init_state(jt.cfg.seed)
    init = jax.device_get(jt.state.gauss)
    jt.fit()
    pt.state = SystemState(gauss=gaussian_state_from_numpy(init, device="cpu"))
    pt.fit()
    jg, pg = jax.device_get(jt.state.gauss), pt.state.gauss
    arrays = {}
    for field in FIELDS:
        arrays[f"init/{field}"] = np.asarray(getattr(init.params, field))
        arrays[f"jax/{field}"] = np.asarray(getattr(jg.params, field))
        arrays[f"port/{field}"] = getattr(pg.params, field).numpy()
    for stat in ("denom", "xyz_grad_accum"):
        arrays[f"jax/{stat}"] = np.asarray(getattr(jg, stat))
        arrays[f"port/{stat}"] = getattr(pg, stat).numpy()
    meta = {"jax_logs": jt.metrics_log, "port_logs": pt.metrics_log,
            "lrs": pt.system.geometry.lr_tree(0)}
    return meta, arrays


@pytest.fixture(scope="module", params=["synthetic", "png_maps"])
def trained(request, tmp_path_factory):
    """``train_both`` once per configuration in a test session: under
    pytest-xdist every worker that needs a configuration takes a lock in
    the session's shared temporary directory and reads the results the
    first one saved, so the JAX compiles run once, not once per worker."""
    name = request.param
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = shared / f"z123_{name}.json"
    with open(shared / f"z123_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            meta, arrays = train_both(name, tmp_path_factory.mktemp(f"z123_{name}"))
            np.savez(shared / f"z123_{name}.npz", **arrays)
            done.write_text(json.dumps(meta))
    with np.load(shared / f"z123_{name}.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return name, json.loads(done.read_text()), arrays


def test_training_logs_match_jax(trained):
    """Every train/ log of each step (both substeps' losses, the reference
    ones on the PNG with its maps) to 1e-4 relative, no dropped pairs."""
    name, meta, _ = trained
    assert len(meta["jax_logs"]) == len(meta["port_logs"]) == STEPS
    for row_j, row_p in zip(meta["jax_logs"], meta["port_logs"]):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert {"train/loss_zero123_sds", "train/loss_ref_rgb", "train/loss_ref_mask"} <= set(keys)
        if name == "png_maps":
            assert {"train/loss_ref_depth", "train/loss_ref_depth_rel", "train/loss_ref_normal",
                    "train/loss_ref_normal_smooth", "train/loss_zero123_normal_smooth"} <= set(keys)
        for k in keys:
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), (name, k)
        assert row_p["n_dropped_pairs"] == 0 and row_p["zero123/grad_norm"] > 0


@pytest.mark.parametrize("field", FIELDS)
def test_trained_params_match_jax(trained, field):
    """Each field within 2% of its learning rate of the JAX package's,
    having moved by more than its learning rate (the rotation's gradient is
    rounding on the isotropic initial Gaussians: ROADMAP section 3)."""
    _, meta, arrays = trained
    lr = meta["lrs"][field]
    want = arrays[f"jax/{field}"]
    np.testing.assert_allclose(arrays[f"port/{field}"], want, rtol=0, atol=LR_FRACTION * lr)
    assert np.abs(want - arrays[f"init/{field}"]).max() > lr


def test_trained_stats_match_jax(trained):
    """The densification statistics from the last substep (the ref view):
    visibility counts equal, the accumulated NDC gradient norms to 1e-4 of
    their largest."""
    _, _, arrays = trained
    np.testing.assert_array_equal(arrays["port/denom"], arrays["jax/denom"])
    want = arrays["jax/xyz_grad_accum"]
    np.testing.assert_allclose(arrays["port/xyz_grad_accum"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_launcher_entry_points(tmp_path):
    """The zero123 YAML through the port's launcher on the CPU: --train
    (2 steps on a real PNG, the test renders and the PLY), --export and
    --validate from its checkpoint with --resume, --train continued from
    it to step 3, and a warm start from its PLY whose field equals the
    trained one's alive rows."""
    from threestudio_3dgs_tpu_torch import launch

    config = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gaussian_splatting_zero123.yaml"
    small = [f"data.image_path={write_reference(tmp_path)}",
             "data.height=32", "data.width=32",
             "data.random_camera.height=32", "data.random_camera.width=32",
             "data.random_camera.batch_size=1", "data.random_camera.eval_height=32",
             "data.random_camera.eval_width=32", "data.random_camera.n_test_views=2",
             "data.random_camera.n_val_views=1", "system.geometry.init_num_pts=128",
             "system.geometry.capacity=512", "system.renderer.tile_size=16",
             "system.exporter.resolution=32", "trainer.val_check_interval=0"]

    runs = iter("abcd")

    def run(*args):
        # each launch under its own root: two launches within one second
        # share a trial directory (its name carries the time to the second)
        return launch.main(["--config", config, "--device", "cpu"] + list(args[:-1]) + small
                           + [f"exp_root_dir={tmp_path / next(runs)}"] + args[-1])

    trained = run("--train", ["trainer.max_steps=2"])
    ckpt = f"{trained.save_dir}/ckpts/last.ckpt.npz"
    ply = f"{trained.save_dir}/save/point_cloud.ply"
    assert os.path.exists(ply) and len(os.listdir(f"{trained.save_dir}/save/it2-test")) == 2
    exported = run("--export", "--resume", ckpt, [])
    assert exported.step == 2 and os.path.exists(f"{exported.save_dir}/save/export/model.obj")
    resumed = run("--train", "--resume", ckpt, ["trainer.max_steps=3"])
    assert resumed.step == 3 and len(resumed.metrics_log) == 1
    warm = run("--validate", [f"system.geometry_convert_from={ply}"])
    g, alive = trained.state.gauss, trained.state.gauss.alive
    n = int(alive.sum())
    assert int(warm.state.gauss.alive.sum()) == n
    for k, v in g.params.as_dict().items():
        assert torch.equal(getattr(warm.state.gauss.params, k)[:n], v[alive]), k
