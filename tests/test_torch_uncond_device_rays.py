"""The random-camera sampler's rays built on a device (``device_rays``)
against the host's numpy rays on the CPU: the draws stay bit-equal to the
JAX package's sampler under one seed, the rays match ``rays_from_c2w`` on
those draws, ``rays_o`` holds no per-pixel storage, ``ray_builds`` counts
the builds; and one training step's loss and gradients are the same with
either kind of rays."""

import os

import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)
from test_torch_train import ROOT

from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.data.uncond import RandomCameraDataModuleConfig, \
    RandomCameraSampler
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind


def config(package, name):
    return os.path.join(ROOT, package, "configs", name + ".yaml")


# the benchmark YAMLs' data blocks at 64^2 (SD's 4 views, MVDream's 4-view
# scene), and SD's with normalised directions on a wide frame
CASES = {
    "sd21": ("gaussian_splatting", ["data.height=64", "data.width=64"]),
    "mvdream": ("gaussian_splatting_mvdream", ["data.height=[64, 64]", "data.width=[64, 64]"]),
    "normalized": ("gaussian_splatting", ["data.height=48", "data.width=64",
                                          "data.rays_d_normalize=true"]),
}
DRAWS = ("c2w", "fovy", "elevation", "azimuth", "camera_distances", "light_positions",
         "mvp_mtx", "camera_positions", "view_index")
STEPS = 5


@pytest.mark.parametrize("case,device", [(c, "cpu") for c in CASES] + [("sd21", None)],
                         ids=[*CASES, "sd21-host"])
def test_device_rays_match_the_host_sampler(case, device):
    """Five steps of the port's data module (its rays on ``device``, or on
    the host without one) against the JAX package's: bit-equal draws, the
    rays to 1e-6, ``rays_o`` an expand of the B camera positions, and one
    build of the right kind counted per batch."""
    name, overrides = CASES[case]
    jcfg = jax_load_config(config("threestudio_3dgs_tpu", name), overrides)
    pcfg = load_config(config("threestudio_3dgs_tpu_torch", name), overrides)
    jdata = jfind(jcfg.data_type)(jcfg.data, seed=11)
    pdata = pfind(pcfg.data_type)(pcfg.data, seed=11, device=device)
    for step in range(STEPS):
        want, got = jdata.train_batch(step), pdata.train_batch(step)
        for k in DRAWS:
            assert isinstance(got[k], np.ndarray), k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        b, h, w = want["c2w"].shape[0], int(want["height"]), int(want["width"])
        for k in ("rays_o", "rays_d"):
            assert tuple(got[k].shape) == (b, h, w, 3) and got[k].dtype in (np.float32,
                                                                               torch.float32)
            if device is None:
                assert isinstance(got[k], np.ndarray), k
            else:
                assert isinstance(got[k], torch.Tensor) and got[k].device == torch.device(device)
            np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        if device is not None:
            rays_o = got["rays_o"]
            assert rays_o.stride()[1:3] == (0, 0)
            assert rays_o.untyped_storage().nbytes() < 64 * b
    builds = pdata.train_sampler.ray_builds
    assert builds == ({"device": STEPS, "host": 0} if device else {"device": 0, "host": STEPS})


def test_sampler_without_a_device_builds_numpy_rays():
    """A sampler built without a device (the JAX-parity tests, direct
    callers) returns numpy rays, as before."""
    sampler = RandomCameraSampler(RandomCameraDataModuleConfig(height=8, width=8, batch_size=2))
    batch = sampler.sample()
    assert isinstance(batch["rays_o"], np.ndarray) and isinstance(batch["rays_d"], np.ndarray)
    assert sampler.ray_builds == {"device": 0, "host": 1}


# gaussian_splatting_shading.yaml at 32^2, B=2: the neural environment-map
# background (its random colour off, so it reads rays_d) and the fake SDS
# target (ray-traced from rays_o / rays_d) both read the rays
SHADING = [
    "data.height=32", "data.width=32", "data.batch_size=2",
    "system.geometry.init_num_pts=128", "system.geometry.capacity=512",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.adaptive_max_pairs=false", "system.background.random_aug=false",
    "system.guidance_type=fake-sds-guidance",
    "system.guidance={target_color: [0.8, 0.2, 0.2], guidance_scale: 3.0, "
    "min_step_percent: 0.5, max_step_percent: 0.5}",
]


def test_step_with_device_rays_matches_numpy_rays():
    """One training step's loss and gradients (field and background) with
    the batch's rays built on the device equal those with the numpy rays of
    the same draws, to 1e-6 relative."""
    cfg = load_config(config("threestudio_3dgs_tpu_torch", "gaussian_splatting_shading"), SHADING)
    system = pfind(cfg.system_type)(cfg.system, device="cpu")
    state = system.init_state(0)
    batches = [pfind(cfg.data_type)(cfg.data, seed=5, device=d).train_batch(0)
               for d in (None, "cpu")]
    assert isinstance(batches[0]["rays_d"], np.ndarray)
    assert isinstance(batches[1]["rays_d"], torch.Tensor)
    results = []
    for batch in batches:
        sched = system.sched_scalars(0)
        generator = torch.Generator().manual_seed(3)
        g_gauss, g_extra, _, _, logs = system.local_gradients(state, batch, 0, sched, generator)
        grads = {k: g for k, g in {**g_gauss, **g_extra}.items() if g.numel()}
        results.append((float(logs["train/loss_total"].detach()), grads))
    (loss_np, grads_np), (loss_dev, grads_dev) = results
    assert loss_dev == pytest.approx(loss_np, rel=1e-6)
    # the isotropic initial Gaussians' rotation takes no gradient
    assert all(torch.linalg.vector_norm(grads_np[k]) > 0
               for k in ("xyz", "features_dc", "opacity", "background/w0"))
    for k, want in grads_np.items():
        gap = torch.linalg.vector_norm(grads_dev[k] - want)
        assert gap <= 1e-6 * torch.linalg.vector_norm(want), k
