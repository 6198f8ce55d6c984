"""The port's multi-view SDS (``sds_loss(n_view=4)``, ``sds_recon_loss``),
its MVDream / ImageDream guidance and the multi-view system against the
JAX package on the CPU.

The guidance runs on the analytic prior (no directory) and on a tiny
random MVDream directory that both packages load: both hard-wire the
published ``MVDREAM_UNET`` and ``SD_VAE`` architectures, so the test swaps
a tiny UNet (with the 4-view fold and the camera MLP) and a tiny VAE into
both packages' module attributes.  The JAX package draws its timesteps and
noises from a key; the port gets the same draws through ``draws=``.
Prompt embeddings are passed in (the JAX package seeds its own from
Python's per-process ``hash``)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diffusion import TINY_MV_UNET, TINY_VAE
from test_torch_diffusion import JAX_ONLY_FIELDS
from test_torch_guidance import FixedPrompt, nchw, rel_l2
from test_torch_train import JAX_ONLY, ROOT

import threestudio_3dgs_tpu.diffusion as jdiff
import threestudio_3dgs_tpu.diffusion.vae as jvae
from threestudio_3dgs_tpu.diffusion import UNet2DCondition as JaxUNet
from threestudio_3dgs_tpu.diffusion import VAEEncoder as JaxEncoder
from threestudio_3dgs_tpu.guidance import sds as jsds
from threestudio_3dgs_tpu.guidance.mvdream import MultiviewDiffusionGuidance as JaxMV
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

import threestudio_3dgs_tpu_torch.diffusion as pdiff
from threestudio_3dgs_tpu_torch.diffusion import convert as pconv
from threestudio_3dgs_tpu_torch.diffusion import unet as punet
from threestudio_3dgs_tpu_torch.diffusion import vae as pvae
from threestudio_3dgs_tpu_torch.guidance import sds as psds
from threestudio_3dgs_tpu_torch.guidance.mvdream import (
    MultiviewDiffusionGuidance, resize_bilinear)
from threestudio_3dgs_tpu_torch.models.convert import extra_from_numpy, gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.ops.gaussian_math import covariance_from_scaling_rotation
from threestudio_3dgs_tpu_torch.systems.base import SystemState, flatten_extra
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

CTX = TINY_MV_UNET.cross_attention_dim
TINY_MV4 = dataclasses.replace(TINY_MV_UNET, num_views=4)


def jax_draws(key, sched, b, n_view, shape):
    """The timestep per scene and the noise the JAX SDS losses draw."""
    k_t, k_eps, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (b // n_view,), sched["min_step"],
                                      sched["max_step"] + 1))
    return torch.tensor(t, dtype=torch.int64), np.asarray(jax.random.normal(k_eps, shape))


def toy_denoiser(lib):
    """An eps model whose conditional and unconditional halves differ, so
    the CFG mix matters: (0.3 x + t / 1000, 0.5 x - 0.1)."""
    def fn(noisy, t, *_):
        tt = t.reshape((-1,) + (1,) * (noisy.ndim - 1)) / 1000.0
        return 0.3 * noisy + tt, 0.5 * noisy - 0.1
    return fn


@pytest.mark.parametrize("mode", ["sds", "recon_0.5", "recon_0"])
def test_multiview_sds_losses_match_jax(mode):
    """B = 8 (two scenes of four views): the loss, grad_norm and the
    gradient w.r.t. the latents, f32 to 1e-5 relative; each scene's four
    views share their timestep."""
    cfg_j, cfg_p = jsds.SDSConfig(guidance_scale=7.5), psds.SDSConfig(guidance_scale=7.5)
    sched = jsds.sds_sched_scalars(cfg_j, 0)
    x = np.random.default_rng(0).normal(size=(8, 6, 6, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    t, noise = jax_draws(key, sched, 8, 4, x.shape)
    seen = []

    def port_fn(noisy, tt):
        seen.append(tt.clone())
        return toy_denoiser(torch)(noisy, tt.float())

    def jax_fn(noisy, tt, k):
        return toy_denoiser(jnp)(noisy, tt.astype(jnp.float32))

    if mode == "sds":
        jfun = lambda v: jsds.sds_loss(v, jax_fn, key, sched, cfg_j, n_view=4)  # noqa: E731
        pfun = lambda v: psds.sds_loss(  # noqa: E731
            v, port_fn, None, psds.sds_sched_scalars(cfg_p, 0), cfg_p, psds.ddpm_alphas_cumprod(),
            t=t, noise=torch.tensor(noise), n_view=4)
    else:
        rescale = float(mode.split("_")[1])
        jfun = lambda v: jsds.sds_recon_loss(  # noqa: E731
            v, jax_fn, key, sched, cfg_j, n_view=4, recon_std_rescale=rescale)
        pfun = lambda v: psds.sds_recon_loss(  # noqa: E731
            v, port_fn, None, psds.sds_sched_scalars(cfg_p, 0), cfg_p, psds.ddpm_alphas_cumprod(),
            n_view=4, recon_std_rescale=rescale, t=t, noise=torch.tensor(noise))
    (loss_j, aux_j), grad_j = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    loss_p, aux_p = pfun(xt)
    loss_p.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(aux_p["grad_norm"]) == pytest.approx(float(aux_j["grad_norm"]), rel=1e-5)
    assert rel_l2(xt.grad.numpy(), grad_j) <= 1e-5
    assert torch.equal(seen[0], torch.repeat_interleave(t, 4))


@pytest.mark.parametrize("size,target", [(64, 32), (48, 32), (40, 16), (16, 32), (32, 32)])
def test_resize_matches_jax_image_resize(size, target):
    """The renders' resize to image_size: jax.image.resize(..., "bilinear")
    (antialiased when it downsamples) and the port's, to 1e-6."""
    x = np.random.default_rng(size).uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, target, target, 3), "bilinear"))
    got = resize_bilinear(nchw(x), target).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def mv_batch(b=8, seed=0):
    """c2w of b views looking at the origin from distance ~2-3."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    c2w[:, :3, :3] = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0]
    c2w[:, :3, 3] = rng.normal(size=(b, 3)) * 1.5
    return {"c2w": c2w.astype(np.float32)}


def guidance_pair(path, **kw):
    cfg = {"pretrained_model_name_or_path": path, "n_view": 4, **kw}
    return JaxMV(cfg=dict(cfg)), MultiviewDiffusionGuidance(dict(cfg), device="cpu")


@pytest.mark.parametrize("kw", [{}, {"recon_loss": False}, {"ip_mode": "pixel"}],
                         ids=["recon", "sds", "ip_mode_ignored"])
def test_analytic_fallback_matches_jax(kw):
    """No directory: the prompt-colour prior through the multi-view SDS;
    loss, grad_norm and the gradient w.r.t. rgb, f32 to 1e-5 relative."""
    jg, pg = guidance_pair("no/such/dir", **kw)
    assert jg.denoiser is None and pg.denoiser is None
    rng = np.random.default_rng(1)
    rgb = rng.uniform(size=(8, 16, 16, 3)).astype(np.float32)
    emb = FixedPrompt(rng.normal(size=(77, 1024)).astype(np.float32))
    key = jax.random.PRNGKey(3)
    sched = jg.sched_scalars(0)
    (loss_j, out_j), grad_j = jax.value_and_grad(
        lambda x: (lambda o: (o["loss_sds"], o))(jg(x, emb, {}, key=key, sched=sched)),
        has_aux=True)(jnp.asarray(rgb))
    t, noise = jax_draws(key, sched, 8, 4, rgb.shape)
    x = torch.tensor(rgb, requires_grad=True)
    out = pg(x, emb, {}, sched=pg.sched_scalars(0), draws={"t": t, "noise": torch.tensor(noise)})
    out["loss_sds"].backward()
    assert float(out["loss_sds"].detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(out["grad_norm"]) == pytest.approx(float(out_j["grad_norm"]), rel=1e-5)
    assert rel_l2(x.grad.numpy(), grad_j) <= 1e-5


PORT_MV4 = punet.UNet2DConditionConfig(**{f.name: getattr(TINY_MV4, f.name)
                                         for f in dataclasses.fields(TINY_MV4)
                                         if f.name not in JAX_ONLY_FIELDS})
PORT_VAE = pvae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)


@pytest.fixture(scope="module")
def tiny_mv_files(tmp_path_factory):
    """unet/ (the tiny 4-view UNet with its camera MLP) and vae/ (the tiny
    VAE), Flax init weights as diffusers .bin files."""
    root = tmp_path_factory.mktemp("mv_tiny")
    key = jax.random.PRNGKey(11)
    unet = jax.jit(JaxUNet(TINY_MV4).init)(
        key, jnp.zeros((4, 8, 8, 4)), jnp.zeros((4,), jnp.int32), jnp.zeros((4, 3, CTX)),
        jnp.zeros((4, 16)))
    enc = jax.jit(JaxEncoder(TINY_VAE).init)(key, jnp.zeros((1, 16, 16, 3)))
    files = {"unet": (pconv.unet_config_to_diffusers(PORT_MV4),
                      pconv.flax_unet_to_torch(jax.device_get(unet))),
             "vae": (pconv.vae_config_to_diffusers(PORT_VAE),
                     pconv.flax_vae_encoder_to_torch(jax.device_get(enc)))}
    for sub, (cfg, sd) in files.items():
        os.makedirs(root / sub)
        (root / sub / "config.json").write_text(json.dumps(cfg))
        torch.save(sd, root / sub / "diffusion_pytorch_model.bin")
    return str(root)


@pytest.fixture()
def tiny_mv_dir(tiny_mv_files, monkeypatch):
    """The tiny directory, with both packages' MVDREAM_UNET and SD_VAE
    pointing at the tiny architectures for the test."""
    monkeypatch.setattr(jdiff, "MVDREAM_UNET", TINY_MV4)
    monkeypatch.setattr(jvae, "SD_VAE", TINY_VAE)
    monkeypatch.setattr(pdiff, "MVDREAM_UNET", PORT_MV4)
    monkeypatch.setattr(pdiff, "SD_VAE", PORT_VAE)
    return tiny_mv_files


def test_local_denoiser_and_camera_match_jax(tiny_mv_dir):
    """Both packages load the tiny directory: the camera condition, and the
    CFG denoiser's eps (zero unconditional context, 4-view fold, camera
    MLP) on the same latents, t and context, f32 rel-L2 1e-4."""
    jg, pg = guidance_pair(tiny_mv_dir)
    assert pg.unet is not None and pg.vae_encoder is not None
    assert pg.unet.cfg.num_views == 4 and pg.unet.conv_in.weight.dtype == torch.float32
    batch = mv_batch()
    cam_j = np.asarray(jg.camera_condition(batch, 8))
    cam_p = pg.camera_condition(batch, 8, "cpu").numpy()
    np.testing.assert_allclose(cam_p, cam_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(cam_p.reshape(8, 4, 4)[:, :3, 3], axis=-1), 1.0,
                               atol=1e-6)
    rng = np.random.default_rng(1)
    noisy = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    t = np.repeat(np.array([100, 700], np.int32), 4)
    emb = rng.normal(size=(5, CTX)).astype(np.float32)
    ctx = (jnp.zeros_like(emb), jnp.asarray(emb))
    eps_j = jg.denoiser(jnp.asarray(noisy), jnp.asarray(t), None, ctx, jnp.asarray(cam_j))
    eps_p = pg.denoiser(nchw(noisy), torch.tensor(t, dtype=torch.int64),
                        (torch.zeros(5, CTX), torch.tensor(emb)), torch.tensor(cam_p))
    for j, p in zip(eps_j, eps_p):
        assert rel_l2(p.permute(0, 2, 3, 1).numpy(), j) <= 1e-4


@pytest.mark.parametrize("recon", [True, False], ids=["recon", "sds"])
def test_guidance_call_matches_jax(tiny_mv_dir, recon):
    """The whole call on 64^2 renders: resize to image_size 32, VAE encode,
    CFG UNet at guidance scale 50, (recon) SDS; loss, grad_norm and the
    gradient w.r.t. rgb with the JAX draws fed in: rel 1e-3 (the CFG
    difference is multiplied by 50)."""
    jg, pg = guidance_pair(tiny_mv_dir, image_size=32, recon_loss=recon)
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(8, 64, 64, 3)).astype(np.float32)
    emb = FixedPrompt(rng.normal(size=(77, CTX)).astype(np.float32) * 0.5)
    batch = mv_batch(seed=3)
    key = jax.random.PRNGKey(5)
    sched = jg.sched_scalars(0)
    (loss_j, out_j), grad_j = jax.value_and_grad(
        lambda x: (lambda o: (o["loss_sds"], o))(jg(x, emb, batch, key=key, sched=sched)),
        has_aux=True)(jnp.asarray(rgb))
    k_enc, key = jax.random.split(key)
    latent = (8, 16, 16, 4)  # the tiny VAE downsamples 32^2 by 2
    latent_noise = np.asarray(jax.random.normal(k_enc, latent))
    t, noise = jax_draws(key, sched, 8, 4, latent)
    x = torch.tensor(rgb, requires_grad=True)
    out = pg(x, emb, batch, sched=pg.sched_scalars(0),
             draws={"t": t, "noise": nchw(noise), "latent_noise": nchw(latent_noise)})
    out["loss_sds"].backward()
    assert np.isfinite(float(out["loss_sds"].detach())) and float(out["grad_norm"]) > 0
    assert float(out["loss_sds"].detach()) == pytest.approx(float(loss_j), rel=1e-3)
    assert float(out["grad_norm"]) == pytest.approx(float(out_j["grad_norm"]), rel=1e-3)
    assert rel_l2(x.grad.numpy(), grad_j) <= 1e-3


def test_registered_names():
    assert pfind("mvdream-multiview-diffusion-guidance") is MultiviewDiffusionGuidance
    assert pfind("multiview-diffusion-guidance") is MultiviewDiffusionGuidance
    assert pfind("gaussian-splatting-mvdream-system").__name__ == "MVDreamSystem"


# ---------------------------------------------------------------------------
# Training: 3 steps of the shading and MVDream YAMLs in both packages
# ---------------------------------------------------------------------------

STEPS = 3
# 64^2, tile 16, 256 points in a 1536 field, with the stochastic parts
# pinned: no background augmentation, no soft shading, diffuse_prob 1 (so
# after the one ambient-only step every view is shaded, never albedo), and
# min_step_percent == max_step_percent, so the analytic prior's noise
# cancels from its target up to rounding
COMMON = [
    f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0",
    "data.width=64", "data.height=64",
    "system.geometry.init_num_pts=256", "system.geometry.capacity=1536",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.batched=false", "system.renderer.adaptive_max_pairs=false",
    "system.background.random_aug=false", "system.material.soft_shading=false",
    "system.material.diffuse_prob=1.0", "system.material.ambient_only_steps=1",
    "system.guidance.min_step_percent=0.5", "system.guidance.max_step_percent=0.5",
]
YAMLS = {"shading": ["data.batch_size=2"], "mvdream": ["data.batch_size=4"]}
# each field within 2% of its learning rate of the JAX package's, having
# moved by more than its learning rate.  The rotation is held through the
# covariance it gives: the initial Gaussians are isotropic, so their
# rotation's gradient is rounding, which Adam turns into steps of +-lr in
# either package (ROADMAP section 3)
LR_FRACTION = 0.02
FIELDS = ("xyz", "features_dc", "scaling", "opacity")


@pytest.fixture(scope="module", params=sorted(YAMLS))
def trained(request, tmp_path_factory):
    """Both packages trained STEPS steps of the YAML from the JAX package's
    initial state (the field and the background MLP carried over), with the
    port's CRC32 prompt embedding given to the JAX prompt utils."""
    name = request.param
    root = tmp_path_factory.mktemp(f"train_{name}")
    overrides = COMMON + YAMLS[name]
    yaml = f"gaussian_splatting_{name}.yaml"
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
    return name, jt, pt, init


def test_training_logs_match_jax(trained):
    name, jt, pt, _ = trained
    assert len(jt.metrics_log) == len(pt.metrics_log) == STEPS
    for row_j, row_p in zip(jt.metrics_log, pt.metrics_log):
        keys = sorted(k for k in row_j if k.startswith("train/"))
        assert keys == sorted(k for k in row_p if k.startswith("train/"))
        assert "train/loss_depth_tv" in keys
        if name == "mvdream":
            assert "train/loss_sparsity" in keys
        for k in keys:
            assert row_p[k] == pytest.approx(row_j[k], rel=1e-4, abs=1e-7), (name, k)
        assert row_p["n_dropped_pairs"] == row_j["n_dropped_pairs"] == 0


@pytest.mark.parametrize("field", FIELDS)
def test_trained_params_match_jax(trained, field):
    _, jt, pt, init = trained
    lr = pt.system.geometry.lr_tree(0)[field]
    want = np.asarray(getattr(jax.device_get(jt.state.gauss.params), field))
    got = getattr(pt.state.gauss.params, field).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_FRACTION * lr)
    assert np.abs(want - np.asarray(getattr(init.gauss.params, field))).max() > lr


def test_trained_covariances_match_jax(trained):
    """The covariances of the trained scales and rotations, to 1e-4 of
    the largest entry."""
    _, jt, pt, _ = trained
    jp = jax.device_get(jt.state.gauss.params)

    def cov(scaling, rotation):
        return covariance_from_scaling_rotation(torch.exp(torch.tensor(np.array(scaling))),
                                                torch.tensor(np.array(rotation))).numpy()

    want = cov(jp.scaling, jp.rotation)
    got = cov(pt.state.gauss.params.scaling, pt.state.gauss.params.rotation)
    alive = pt.state.gauss.alive.numpy()
    np.testing.assert_allclose(got[alive], want[alive], rtol=0,
                               atol=1e-4 * np.abs(want[alive]).max())


def test_trained_background_matches_jax(trained):
    """The background MLP after STEPS Adam steps at extra_lr: within 2% of
    the lr of the JAX package's, having moved by more than the lr."""
    _, jt, pt, init = trained
    lr = pt.system.extra_lr
    assert pt.state.extra_opt.count == STEPS
    for k, got in flatten_extra(pt.state.extra_params).items():
        group, leaf = k.split("/")
        want = np.asarray(jax.device_get(jt.state.extra_params)[group][leaf])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LR_FRACTION * lr, err_msg=k)
        assert np.abs(want - np.asarray(init.extra_params[group][leaf])).max() > lr, k
