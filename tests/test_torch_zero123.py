"""The port's Zero123 guidance stack against the JAX package on the CPU:
the ldm checkpoint converters and the config inference on a tiny seeded
ldm ``.ckpt``, the camera embedding of both variants,
``zero123_context``, the analytic prior, and the real denoiser built by
``prepare_embeddings`` from the tiny ``.ckpt`` (with and without an
``image_encoder/`` beside it): loss and gradient w.r.t. the renders with the
JAX draws fed in.  The CLIP image tower is held against ``transformers``
and the JAX package in tests/test_torch_prompt.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_torch_diffusion import JAX_ONLY_FIELDS
from test_torch_guidance import nchw, rel_l2
from test_torch_mvdream import jax_draws

from threestudio_3dgs_tpu.diffusion import convert as jconv
from threestudio_3dgs_tpu.guidance import temporal_zero123 as jz

from threestudio_3dgs_tpu_torch.diffusion import convert as pconv
from threestudio_3dgs_tpu_torch.diffusion import unet as punet
from threestudio_3dgs_tpu_torch.diffusion import vae as pvae
from threestudio_3dgs_tpu_torch.guidance import clip as pclip
from threestudio_3dgs_tpu_torch.guidance import temporal_zero123 as pz
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

# a tiny Zero123-shaped UNet (8 input channels, 1x1-conv projections, 32
# channels at level 0 so ZERO123_UNET's 8 heads divide it) and VAE (one
# downsampling, 32^2 conditioning -> 16^2 latents)
TINY_UNET = punet.UNet2DConditionConfig(
    in_channels=8, block_out_channels=(32, 64), attention_head_dim=(8, 8),
    cross_attention_dim=24, use_linear_projection=False,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
TINY_VAE = pvae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=16)
CLIP_DIM = 24
TINY_VISION = pclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                     projection_dim=CLIP_DIM, num_hidden_layers=2,
                                     num_attention_heads=4, image_size=16, patch_size=4)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The tiny checkpoint in ldm layout, alone in one directory and beside
    a random image_encoder/ in another; and the same weights as a
    diffusers-layout directory (unet/, vae/, image_encoder/,
    clip_camera_projection/)."""
    root = tmp_path_factory.mktemp("z123")
    for sub in ("bare", "clip"):
        os.makedirs(root / sub)
        pconv.write_random_ldm_checkpoint(str(root / sub / "tiny.ckpt"), TINY_UNET, TINY_VAE,
                                          clip_dim=CLIP_DIM, seed=3, device="cpu")
    pclip.write_random_image_encoder(str(root / "clip" / "image_encoder"), TINY_VISION, seed=4)
    sd = pconv.load_torch_state_dict(str(root / "bare" / "tiny.ckpt"))
    parts = {"unet": pconv.ldm_unet_to_diffusers(sd),
             "vae": pconv.ldm_vae_encoder_to_diffusers(sd),
             "clip_camera_projection": {"proj.weight": sd["cc_projection.weight"],
                                        "proj.bias": sd["cc_projection.bias"]}}
    for sub, weights in parts.items():
        os.makedirs(root / "dir" / sub)
        torch.save(weights, root / "dir" / sub / "diffusion_pytorch_model.bin")
    pclip.write_random_image_encoder(str(root / "dir" / "image_encoder"), TINY_VISION, seed=4)
    return root


def as_np(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def test_ldm_converters_match_jax(tiny_ckpt):
    """The .ckpt read by both packages' loaders (Lightning nesting; the
    step, epoch, betas and EMA decay skipped by the converters), converted
    to diffusers naming: equal key sets and equal tensors; the configs
    inferred from the shapes equal; the port's inferred UNet is the one
    written."""
    path = str(tiny_ckpt / "bare" / "tiny.ckpt")
    jsd, psd = jconv.load_torch_state_dict(path), pconv.load_torch_state_dict(path)
    assert sorted(jsd) == sorted(psd) and "betas" in psd and "global_step" not in psd
    assert jconv.is_ldm_state_dict(jsd) and pconv.is_ldm_state_dict(psd)
    for name in ("ldm_unet_to_diffusers", "ldm_vae_encoder_to_diffusers"):
        want, got = getattr(jconv, name)(jsd), as_np(getattr(pconv, name)(psd))
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    unet_sd, vae_sd = pconv.ldm_unet_to_diffusers(psd), pconv.ldm_vae_encoder_to_diffusers(psd)
    assert not pconv.is_ldm_state_dict(unet_sd)
    for name, sd in (("infer_unet_config_from_state_dict", unet_sd),
                     ("infer_vae_config_from_state_dict", vae_sd)):
        want = dataclasses.asdict(getattr(jconv, name)(as_np(sd)))
        got = dataclasses.asdict(getattr(pconv, name)(sd))
        assert {k: v for k, v in want.items() if k not in JAX_ONLY_FIELDS} == {
            k: v for k, v in got.items() if k not in JAX_ONLY_FIELDS}, name
    assert pconv.infer_unet_config_from_state_dict(unet_sd) == dataclasses.replace(
        TINY_UNET, norm_groups=32)
    assert pconv.infer_vae_config_from_state_dict(vae_sd) == TINY_VAE


def frames(n=1, size=40, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


def camera_batch(b=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"elevation": rng.uniform(-10, 80, b).astype(np.float32),
            "azimuth": rng.uniform(-180, 180, b).astype(np.float32),
            "camera_distances": rng.uniform(3, 4, b).astype(np.float32)}


GUIDANCES = ["temporal-zero123-guidance", "temporal-stable-zero123-guidance",
             "stable-zero123-guidance", "zero123-guidance"]
COND = {"cond_elevation_deg": 5.0, "cond_azimuth_deg": 30.0, "cond_camera_distance": 3.8}


def guidance_pair(name, **kw):
    from threestudio_3dgs_tpu.utils.registry import registry as jreg

    cfg = dict(COND, **kw)
    return jreg[name](dict(cfg)), pfind(name)(dict(cfg), device="cpu")


@pytest.mark.parametrize("name", GUIDANCES)
def test_camera_embedding_and_context_match_jax(name):
    """The relative camera (the zero123 variant's distance channel, the
    stable variants' deg2rad(90 - cond elevation)) to 1e-6, and
    zero123_context through a random cc_projection to 1e-5."""
    jg, pg = guidance_pair(name)
    assert type(pg).stable_variant == type(jg).stable_variant
    batch = camera_batch()
    want = np.asarray(jg.camera_embedding(batch))
    got = pg.camera_embedding(batch).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(2)
    clip_emb = rng.normal(size=(4, 8)).astype(np.float32)
    w, b = rng.normal(size=(12, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32)
    ctx_j = np.asarray(jz.zero123_context(jnp.asarray(clip_emb), jnp.asarray(want),
                                          jnp.asarray(w), jnp.asarray(b)))
    ctx_p = pz.zero123_context(torch.tensor(clip_emb), torch.tensor(got), torch.tensor(w),
                               torch.tensor(b)).numpy()
    assert ctx_p.shape == (4, 1, 8)
    np.testing.assert_allclose(ctx_p, ctx_j, rtol=0, atol=1e-5)


def call_pair(jg, pg, rgb, batch, latent=None):
    """Both guidances on the same renders: the JAX call under its key, the
    port's with the JAX draws (the encoder noise, t, the SDS noise) fed in.
    Returns ((loss, grad_norm, grad) JAX, (...) port)."""
    key = jax.random.PRNGKey(7)
    sched = jg.sched_scalars(0)
    (loss_j, out_j), grad_j = jax.jit(jax.value_and_grad(
        lambda x: (lambda o: (o["loss_sds"], o))(jg(x, None, batch, key=key, sched=sched)),
        has_aux=True))(jnp.asarray(rgb))
    draws = {}
    if latent is not None:
        k_enc, key = jax.random.split(key)
        draws["latent_noise"] = nchw(np.asarray(jax.random.normal(k_enc, latent)))
    shape = latent if latent is not None else rgb.shape
    t, noise = jax_draws(key, sched, rgb.shape[0], 1, shape)
    draws["t"] = t
    draws["noise"] = nchw(noise) if latent is not None else torch.tensor(noise)
    x = torch.tensor(rgb, requires_grad=True)
    out = pg(x, None, batch, sched=pg.sched_scalars(0), draws=draws)
    out["loss_sds"].backward()
    return ((float(loss_j), float(out_j["grad_norm"]), np.asarray(grad_j)),
            (float(out["loss_sds"].detach()), float(out["grad_norm"]), x.grad.numpy()))


@pytest.mark.parametrize("prepared", [False, True], ids=["grey", "prepared"])
@pytest.mark.parametrize("name", ["stable-zero123-guidance", "temporal-zero123-guidance"])
def test_analytic_prior_matches_jax(name, prepared):
    """Without a checkpoint the analytic prior: its clean image is 0.5 grey
    (the single-image system's case) or, after prepare_embeddings, the
    frame's mean colour; loss, grad_norm and the gradient w.r.t. rgb to
    1e-5 relative with the JAX draws."""
    jg, pg = guidance_pair(name, pretrained_model_name_or_path="", guidance_scale=3.0)
    if prepared:
        f = frames(size=24, seed=5)
        jg.prepare_embeddings(f)
        pg.prepare_embeddings(f)
    assert pg.denoiser is None
    rgb = np.random.default_rng(6).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    (lj, gnj, gj), (lp, gnp, gp) = call_pair(jg, pg, rgb, camera_batch(2))
    assert lp == pytest.approx(lj, rel=1e-5) and gnp == pytest.approx(gnj, rel=1e-5)
    assert rel_l2(gp, gj) <= 1e-5


@pytest.mark.parametrize("source", ["ckpt_stand_in", "ckpt_clip", "directory"])
def test_ldm_guidance_matches_jax(tiny_ckpt, source):
    """prepare_embeddings in f32 (half_precision_weights false),
    conditioning size 32, on the tiny .ckpt (the JAX package's stand-in
    CLIP embeddings, or the image tower beside the file) and on the same
    weights as a diffusers directory: the c_concat posterior modes, the
    CLIP embeddings and cc_projection to 1e-5, and one call on two 32^2
    renders (VAE encode, CFG pair with the zero unconditional context and
    c_concat, SDS): loss, grad_norm and the gradient w.r.t. rgb to 1e-4
    relative with the JAX draws."""
    path = str({"ckpt_stand_in": tiny_ckpt / "bare" / "tiny.ckpt",
                "ckpt_clip": tiny_ckpt / "clip" / "tiny.ckpt",
                "directory": tiny_ckpt / "dir"}[source])
    jg, pg = guidance_pair("stable-zero123-guidance", pretrained_model_name_or_path=path,
                           half_precision_weights=False, cond_image_size=32)
    f = frames(size=48, seed=8)
    jg.prepare_embeddings(f)
    pg.prepare_embeddings(f)
    assert pg.unet is not None and pg.unet.conv_in.weight.dtype == torch.float32
    assert pg.unet.cfg.in_channels == 8 and pg.unet.cfg.cross_attention_dim == CLIP_DIM
    np.testing.assert_allclose(pg.cond_crossattn.numpy(), np.asarray(jg.cond_crossattn),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pg.cond_concat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg.cond_concat), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pg.cc_w.numpy(), np.asarray(jg.cc_w))
    rgb = np.random.default_rng(9).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    (lj, gnj, gj), (lp, gnp, gp) = call_pair(jg, pg, rgb, camera_batch(2, seed=3),
                                             latent=(2, 16, 16, 4))
    assert np.isfinite(lp) and gnp > 0
    assert lp == pytest.approx(lj, rel=1e-4) and gnp == pytest.approx(gnj, rel=1e-4)
    assert rel_l2(gp, gj) <= 1e-4


def test_bf16_denoiser_built_half(tiny_ckpt):
    """With half_precision_weights (the default) the UNet and VAE compute
    in bf16 with their norms' weights in f32, as the JAX package's
    cast_params_half and the SD guidance build them."""
    pg = pfind("stable-zero123-guidance")(
        {"pretrained_model_name_or_path": str(tiny_ckpt / "bare" / "tiny.ckpt"),
         "cond_image_size": 32}, device="cpu")
    pg.prepare_embeddings(frames(size=32))
    for module in (pg.unet, pg.vae_encoder):
        assert module.cfg.dtype == torch.bfloat16
        for n, p in module.named_parameters():
            assert p.dtype == (torch.float32 if "norm" in n else torch.bfloat16), n
    x = torch.tensor(frames(2, size=32, seed=1), requires_grad=True)
    out = pg(x, None, camera_batch(2))
    out["loss_sds"].backward()
    assert np.isfinite(float(out["loss_sds"].detach())) and bool(torch.isfinite(x.grad).all())


def test_registered_names():
    for name in GUIDANCES:
        assert issubclass(pfind(name), pz._TemporalZero123Base)
    assert pfind("stable-zero123-guidance") is pfind("zero123-guidance")
