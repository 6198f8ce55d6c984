"""The port's diffusion stack (threestudio_3dgs_tpu_torch.diffusion) against
the JAX package on the CPU.

The tiny configs of tests/test_diffusion.py, Flax init parameters carried
into the port's modules by the carrier (``flax_*_to_torch``), and seeded
numpy inputs in each package's layout (NHWC for JAX, NCHW for the port)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_checkpoint_formats import diffusers_unet_manifest, diffusers_vae_encoder_manifest
from test_diffusion import TINY_MV_UNET, TINY_UNET, TINY_VAE

from threestudio_3dgs_tpu.diffusion import UNet2DCondition as JaxUNet
from threestudio_3dgs_tpu.diffusion import VAEDecoder as JaxDecoder
from threestudio_3dgs_tpu.diffusion import VAEEncoder as JaxEncoder
from threestudio_3dgs_tpu.diffusion import convert as jconv
from threestudio_3dgs_tpu.diffusion.unet import timestep_embedding as jax_temb

from threestudio_3dgs_tpu_torch.diffusion import convert as pconv
from threestudio_3dgs_tpu_torch.diffusion import unet as punet
from threestudio_3dgs_tpu_torch.diffusion import vae as pvae


# JAX config fields the port's configs do not have: the compute type is set
# by fast_model_config, and the port routes every UNet's attention
JAX_ONLY_FIELDS = ("dtype", "use_flash_attention")


def port_config(jax_cfg, cls):
    """The port's config with the JAX config's fields (compute type f32)."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)
                  if f.name not in JAX_ONLY_FIELDS})


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def unet_case(jax_cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.normal(size=(2, 7, jax_cfg.cross_attention_dim)).astype(np.float32)
    args = [x, t, ctx]
    if jax_cfg.camera_embed_dim:
        args.append(rng.normal(size=(2, jax_cfg.camera_embed_dim)).astype(np.float32))
    params = jax.device_get(JaxUNet(jax_cfg).init(jax.random.PRNGKey(seed), *args))
    return params, args


def port_unet(jax_cfg, params, half=False):
    cfg = port_config(jax_cfg, punet.UNet2DConditionConfig)
    if half:
        cfg = pconv.fast_model_config(cfg, True)
    model = punet.UNet2DCondition(cfg)
    model.load_state_dict(pconv.flax_unet_to_torch(params), strict=True)
    return pconv.cast_half(model) if half else model


def run_port_unet(model, args):
    x, t, ctx, *cam = args
    with torch.no_grad():
        out = model(nchw(x), torch.tensor(t), torch.tensor(ctx),
                    torch.tensor(cam[0]) if cam else None)
    return nhwc(out)


# ---------------------------------------------------------------------------
# Modules in f32
# ---------------------------------------------------------------------------

# XLA's f32 exp rounds 18 of the 160 SD frequencies one ulp off the
# correctly rounded value (torch's rounds 2), and a one-ulp frequency
# (<= 6e-8) moves cos(t f) by up to t * 6e-8: 1e-6 holds for t <= 10, and
# larger t are held to 1e-6 + t * 2^-24.
@pytest.mark.parametrize("t", [[0.0, 1.0, 3.0, 10.0], [0.0, 1.0, 500.0, 999.0]])
def test_timestep_embedding_matches_jax(t):
    t = np.array(t, np.float32)
    want = np.asarray(jax_temb(jnp.asarray(t), 320))
    got = punet.timestep_embedding(torch.tensor(t), 320).numpy()
    tol = 1e-6 + t[:, None] * 2.0**-24
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("jax_cfg", [TINY_UNET, TINY_MV_UNET], ids=["sd", "multiview"])
def test_unet_forward_matches_jax(jax_cfg):
    params, args = unet_case(jax_cfg)
    want = np.asarray(JaxUNet(jax_cfg).apply(params, *args))
    got = run_port_unet(port_unet(jax_cfg, params), args)
    assert got.shape == want.shape
    assert rel_l2(got, want) <= 1e-4  # f32 summation order only


def test_vae_encoder_and_vjp_match_jax():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    enc = JaxEncoder(TINY_VAE)
    params = jax.device_get(enc.init(jax.random.PRNGKey(1), rgb))
    want, vjp = jax.vjp(lambda r: enc.apply(params, r), jnp.asarray(rgb))
    cot = rng.normal(size=want.shape).astype(np.float32)
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])

    model = pvae.VAEEncoder(port_config(TINY_VAE, pvae.AutoencoderKLConfig))
    model.load_state_dict(pconv.flax_vae_encoder_to_torch(params), strict=True)
    x = nchw(rgb).requires_grad_(True)
    got = model(x)
    got.backward(nchw(cot))
    assert rel_l2(nhwc(got), want) <= 1e-4
    assert rel_l2(nhwc(x.grad), want_grad) <= 1e-4


def test_vae_decoder_matches_jax():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    dec = JaxDecoder(TINY_VAE)
    params = jax.device_get(dec.init(jax.random.PRNGKey(2), z))
    want = np.asarray(dec.apply(params, z))
    model = pvae.VAEDecoder(port_config(TINY_VAE, pvae.AutoencoderKLConfig))
    model.load_state_dict(pconv.flax_vae_decoder_to_torch(params), strict=True)
    with torch.no_grad():
        got = nhwc(model(nchw(z)))
    assert got.shape == (2, 16, 16, 3)
    assert rel_l2(got, want) <= 1e-4


def test_sample_latents_matches_jax():
    from threestudio_3dgs_tpu.diffusion.vae import sample_latents as jax_sample

    rng = np.random.default_rng(3)
    moments = rng.normal(size=(2, 4, 4, 8)).astype(np.float32) * 3
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_sample(jnp.asarray(moments), key, 0.18215))
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 4)))
    got = pvae.sample_latents(nchw(moments), 0.18215, noise=nchw(noise))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# bf16: the port's production path against the JAX package's
# ---------------------------------------------------------------------------


def test_bf16_unet_matches_jax_bf16():
    """bf16 conv / dense weights and compute, f32 norms and softmax, in both
    (cast_params_half + tpu_fast_model_config on the JAX side).  Budget of
    tests/test_guidance_precision.py: 5e-2 relative L2."""
    params, args = unet_case(TINY_UNET, seed=4)
    jcfg = jconv.tpu_fast_model_config(TINY_UNET, half_precision=True)
    want = np.asarray(JaxUNet(jcfg).apply(jconv.cast_params_half(params), *args))
    model = port_unet(TINY_UNET, params, half=True)
    assert model.conv_in.weight.dtype == torch.bfloat16
    got = run_port_unet(model, args)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= 5e-2


def test_bf16_vae_encoder_matches_jax_bf16():
    rng = np.random.default_rng(5)
    rgb = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(JaxEncoder(TINY_VAE).init(jax.random.PRNGKey(5), rgb))
    jcfg = jconv.tpu_fast_model_config(TINY_VAE, half_precision=True)
    want = np.asarray(JaxEncoder(jcfg).apply(jconv.cast_params_half(params), rgb))
    cfg = pconv.fast_model_config(port_config(TINY_VAE, pvae.AutoencoderKLConfig), True)
    model = pvae.VAEEncoder(cfg)
    model.load_state_dict(pconv.flax_vae_encoder_to_torch(params), strict=True)
    pconv.cast_half(model)
    with torch.no_grad():
        got = nhwc(model(nchw(rgb)))
    assert got.dtype == np.float32
    assert rel_l2(got, want) <= 5e-2


def test_cast_half_keeps_norms_f32():
    model = pconv.cast_half(punet.UNet2DCondition(port_config(TINY_UNET,
                                                              punet.UNet2DConditionConfig)))
    kinds = {name: p.dtype for name, p in model.named_parameters()}
    assert all(dt == torch.float32 for n, dt in kinds.items() if "norm" in n)
    assert all(dt == torch.bfloat16 for n, dt in kinds.items() if "norm" not in n)
    assert sum("norm" in n for n in kinds) > 0


# ---------------------------------------------------------------------------
# The carrier and the checkpoint layout
# ---------------------------------------------------------------------------


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def round_trip_case(kind):
    """(Flax params, the port module that loads them, the JAX converter that
    reads its state dict back)."""
    rng = np.random.default_rng(6)
    if kind in ("unet", "multiview"):
        jcfg = TINY_UNET if kind == "unet" else TINY_MV_UNET
        params, _ = unet_case(jcfg, seed=6)
        model = port_unet(jcfg, params)
        return params, model, jconv.torch_unet_to_flax
    rgb = rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    if kind == "encoder":
        params = jax.device_get(JaxEncoder(TINY_VAE).init(jax.random.PRNGKey(6), rgb))
        model = pvae.VAEEncoder(port_config(TINY_VAE, pvae.AutoencoderKLConfig))
        model.load_state_dict(pconv.flax_vae_encoder_to_torch(params), strict=True)
        return params, model, jconv.torch_vae_encoder_to_flax
    z = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    params = jax.device_get(JaxDecoder(TINY_VAE).init(jax.random.PRNGKey(6), z))
    model = pvae.VAEDecoder(port_config(TINY_VAE, pvae.AutoencoderKLConfig))
    model.load_state_dict(pconv.flax_vae_decoder_to_torch(params), strict=True)
    return params, model, jconv.torch_vae_decoder_to_flax


@pytest.mark.parametrize("kind", ["unet", "multiview", "encoder", "decoder"])
def test_carrier_round_trip_bit_for_bit(kind):
    """Flax tree -> port module -> its state_dict -> the JAX package's own
    torch -> Flax converter gives back the original tree exactly."""
    params, model, to_flax = round_trip_case(kind)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = dict(flat(to_flax(sd)["params"]))
    orig = dict(flat(params["params"]))
    assert set(back) == set(orig)
    for key, value in orig.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_sd21_keys_are_diffusers_layout():
    """At SD 2.1-base width the port's state dicts have exactly the keys and
    shapes of a genuine diffusers UNet and VAE encoder (built on the meta
    device: no memory)."""
    with torch.device("meta"):
        unet = punet.UNet2DCondition(punet.SD21_UNET)
        enc = pvae.VAEEncoder(pvae.SD_VAE)
    c = punet.SD21_UNET
    want = diffusers_unet_manifest(c.in_channels, c.out_channels, c.block_out_channels,
                                   c.layers_per_block, c.cross_attention_dim, c.down_block_types,
                                   c.up_block_types, c.use_linear_projection)
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == {
        k: tuple(v) for k, v in want.items()}
    want = diffusers_vae_encoder_manifest((128, 256, 512, 512), 2, 4)
    assert {k: tuple(v.shape) for k, v in enc.state_dict().items()} == {
        k: tuple(v) for k, v in want.items()}
    assert sum(p.numel() for p in unet.parameters()) == 865_910_724


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_config_from_diffusers_json_matches_jax(kind, tmp_path):
    """The port writes the SD 2.1-base config.json; both packages read it to
    the same architecture."""
    path = tmp_path / "config.json"
    if kind == "unet":
        path.write_text(json.dumps(pconv.unet_config_to_diffusers(punet.SD21_UNET)))
        want, got = jconv.unet_config_from_diffusers_json(str(path)), \
            pconv.unet_config_from_diffusers_json(str(path))
        assert got == punet.SD21_UNET
    else:
        path.write_text(json.dumps(pconv.vae_config_to_diffusers(pvae.SD_VAE)))
        want, got = jconv.vae_config_from_diffusers_json(str(path)), \
            pconv.vae_config_from_diffusers_json(str(path))
        assert got == pvae.SD_VAE
    assert port_config(want, type(got)) == got
