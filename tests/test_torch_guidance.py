"""The port's Stable Diffusion guidance (threestudio_3dgs_tpu_torch.guidance.
stable_diffusion) against the JAX package on the CPU.

Both packages load one tiny diffusers-layout checkpoint directory (``.bin``
files written here with ``torch.save`` from Flax init parameters).  The
JAX package draws its SDS timestep and noises from a PRNG key; the port
takes the same draws, recomputed here from that key, through its
test-only ``draws`` keyword.  Prompt embeddings are passed in: the JAX
package seeds its own from Python's per-process ``hash``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from test_diffusion import TINY_UNET, TINY_VAE
from test_torch_diffusion import JAX_ONLY_FIELDS

from threestudio_3dgs_tpu.diffusion import UNet2DCondition as JaxUNet
from threestudio_3dgs_tpu.diffusion import VAEDecoder as JaxDecoder
from threestudio_3dgs_tpu.diffusion import VAEEncoder as JaxEncoder
from threestudio_3dgs_tpu.diffusion.convert import fuse_lora as jax_fuse_lora
from threestudio_3dgs_tpu.guidance.base import PromptProcessorConfig as JaxPromptConfig
from threestudio_3dgs_tpu.guidance.base import PromptUtils as JaxPromptUtils
from threestudio_3dgs_tpu.guidance.stable_diffusion import StableDiffusionGuidance as JaxSD

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.diffusion import convert as pconv
from threestudio_3dgs_tpu_torch.diffusion import unet as punet
from threestudio_3dgs_tpu_torch.diffusion import vae as pvae
from threestudio_3dgs_tpu_torch.guidance.base import VIEW_SUFFIXES, PromptUtils
from threestudio_3dgs_tpu_torch.guidance.stable_diffusion import StableDiffusionGuidance

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_CONFIG = os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs", "gaussian_splatting.yaml")
CTX = TINY_UNET.cross_attention_dim


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


class FixedPrompt:
    """Prompt utils of both packages' interface with one given embedding."""

    def __init__(self, emb):
        self.emb = emb

    def get_text_embeddings(self, elevation=None, azimuth=None, **_):
        return self.emb


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """unet/ and vae/ of the tiny test configs, Flax init weights saved as
    diffusers-layout .bin files."""
    root = tmp_path_factory.mktemp("sd_tiny")
    key = jax.random.PRNGKey(11)
    unet = JaxUNet(TINY_UNET).init(key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                                   jnp.zeros((1, 3, CTX)))
    enc = JaxEncoder(TINY_VAE).init(key, jnp.zeros((1, 16, 16, 3)))
    dec = JaxDecoder(TINY_VAE).init(key, jnp.zeros((1, 8, 8, 4)))
    files = {
        "unet": (pconv.unet_config_to_diffusers(
            punet.UNet2DConditionConfig(**{f.name: getattr(TINY_UNET, f.name)
                                           for f in dataclasses.fields(TINY_UNET)
                                           if f.name not in JAX_ONLY_FIELDS})),
                 pconv.flax_unet_to_torch(jax.device_get(unet))),
        "vae": (pconv.vae_config_to_diffusers(
            pvae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)),
                {**pconv.flax_vae_encoder_to_torch(jax.device_get(enc)),
                 **pconv.flax_vae_decoder_to_torch(jax.device_get(dec))}),
    }
    for sub, (cfg, sd) in files.items():
        os.makedirs(root / sub)
        (root / sub / "config.json").write_text(json.dumps(cfg))
        torch.save(sd, root / sub / "diffusion_pytorch_model.bin")
    return str(root)


def guidances(path, **kw):
    cfg = {"pretrained_model_name_or_path": path, "half_precision_weights": False, **kw}
    return JaxSD(cfg=dict(cfg)), StableDiffusionGuidance(dict(cfg), device="cpu")


def test_analytic_fallback_matches_jax():
    """No local directory: the prompt-colour prior through the SDS math,
    loss and gradient w.r.t. rgb (f32, 1e-5 relative)."""
    jg, pg = guidances("no/such/dir")
    assert jg.denoiser is None and pg.denoiser is None
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    emb = FixedPrompt(rng.normal(size=(77, 1024)).astype(np.float32))
    key = jax.random.PRNGKey(3)
    sched = jg.sched_scalars(0)
    (loss_j, out_j), grad_j = jax.value_and_grad(
        lambda x: (lambda o: (o["loss_sds"], o))(jg(x, emb, {}, key=key, sched=sched)),
        has_aux=True)(jnp.asarray(rgb))
    k_t, k_eps, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (2,), sched["min_step"], sched["max_step"] + 1))
    noise = np.asarray(jax.random.normal(k_eps, rgb.shape))
    x = torch.tensor(rgb, requires_grad=True)
    out = pg(x, emb, {}, sched=pg.sched_scalars(0),
             draws={"t": torch.tensor(t, dtype=torch.int64), "noise": torch.tensor(noise)})
    out["loss_sds"].backward()
    assert float(out["loss_sds"].detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(out["grad_norm"]) == pytest.approx(float(out_j["grad_norm"]), rel=1e-5)
    assert rel_l2(x.grad.numpy(), grad_j) <= 1e-5


def write_lora(path):
    """A peft-named rank-2 adapter (with alpha) on two attention weights of
    the tiny UNet."""
    rng = np.random.default_rng(9)
    lora = {}
    for module, dim in (("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q", 32),
                        ("up_blocks.1.attentions.2.transformer_blocks.0.ff.net.2", 32)):
        din = 4 * dim if module.endswith("net.2") else dim
        lora[f"{module}.lora_A.weight"] = torch.tensor(rng.normal(size=(2, din)), dtype=torch.float32)
        lora[f"{module}.lora_B.weight"] = torch.tensor(rng.normal(size=(dim, 2)), dtype=torch.float32)
        lora[f"{module}.alpha"] = torch.tensor(4.0)
    torch.save(lora, path)


@pytest.mark.parametrize("lora", [False, True], ids=["sd", "lora"])
def test_local_denoiser_matches_jax(tiny_dir, tmp_path, lora):
    """Both packages load the tiny directory (and, for the LoRA guidance, a
    fused adapter); the CFG denoiser's eps on the same noisy latents, t and
    context (f32 rel-L2 1e-4)."""
    kw = {}
    if lora:
        write_lora(tmp_path / "pytorch_lora_weights.bin")
        kw = {"lora_model_name_or_path": str(tmp_path), "lora_scale": 0.5}
    jg, pg = guidances(tiny_dir, **kw)
    assert pg.unet is not None and pg.vae_encoder is not None
    rng = np.random.default_rng(1)
    noisy = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([100, 700], np.int32)
    emb = rng.normal(size=(2, 5, CTX)).astype(np.float32)
    eps_j = jg.denoiser(jnp.asarray(noisy), jnp.asarray(t), None, jnp.asarray(emb))
    eps_p = pg.denoiser(nchw(noisy), torch.tensor(t, dtype=torch.int64), torch.tensor(emb))
    for j, p in zip(eps_j, eps_p):
        assert rel_l2(p.permute(0, 2, 3, 1).numpy(), j) <= 1e-4
    if lora:  # the adapter changed the prior
        plain = guidances(tiny_dir)[1].denoiser(nchw(noisy), torch.tensor(t), torch.tensor(emb))
        assert rel_l2(eps_p[1].numpy(), plain[1].numpy()) > 1e-3


def test_lora_guidance_is_registered():
    from threestudio_3dgs_tpu_torch.utils.registry import find

    assert issubclass(find("stable-diffusion-lora-guidance"), StableDiffusionGuidance)


def test_sds_loss_and_gradient_match_jax(tiny_dir):
    """The whole guidance call (VAE encode, CFG UNet at the config's
    guidance scale 100, SDS) and its gradient w.r.t. rgb, with JAX's draws
    fed in: f32 rel-L2 1e-3.  The CFG difference eps_c - eps_u is
    multiplied by 100, so the f32 summation-order noise of the two UNets
    (~1e-6) reaches the gradient amplified."""
    jg, pg = guidances(tiny_dir)
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    emb = FixedPrompt(rng.normal(size=(77, CTX)).astype(np.float32) * 0.5)
    key = jax.random.PRNGKey(5)
    sched = jg.sched_scalars(0)
    (loss_j, out_j), grad_j = jax.value_and_grad(
        lambda x: (lambda o: (o["loss_sds"], o))(jg(x, emb, {}, key=key, sched=sched)),
        has_aux=True)(jnp.asarray(rgb))
    # the JAX call's draws: encoder noise, then SDS t and noise
    key, k_enc = jax.random.split(key)
    latent_noise = np.asarray(jax.random.normal(k_enc, (2, 16, 16, 4)))
    k_t, k_eps, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (2,), sched["min_step"], sched["max_step"] + 1))
    noise = np.asarray(jax.random.normal(k_eps, (2, 16, 16, 4)))

    x = torch.tensor(rgb, requires_grad=True)
    out = pg(x, emb, {}, sched=pg.sched_scalars(0), draws={
        "t": torch.tensor(t, dtype=torch.int64), "noise": nchw(noise),
        "latent_noise": nchw(latent_noise)})
    out["loss_sds"].backward()
    loss = float(out["loss_sds"].detach())
    assert np.isfinite(loss) and float(out["grad_norm"]) > 0
    assert loss == pytest.approx(float(loss_j), rel=1e-3)
    assert float(out["grad_norm"]) == pytest.approx(float(out_j["grad_norm"]), rel=1e-3)
    assert rel_l2(x.grad.numpy(), grad_j) <= 1e-3


def test_view_dependent_embeddings_match_jax():
    """The same view index as the JAX package over angles that cross every
    threshold, and the embedding of that view's suffixed prompt."""
    elev = np.array([-20, 0, 59.9, 60.1, 89, 10, 10, 10, 10, 10, 10], np.float32)
    azim = np.array([0, 29.9, 30.1, -29.9, 0, 150.1, 149.9, -150.1, 180, 359, -181], np.float32)
    cfg = dict(prompt="a hamburger", front_threshold=30.0, back_threshold=30.0,
               overhead_threshold=60.0)
    want = np.asarray(JaxPromptUtils("a hamburger", cfg=JaxPromptConfig(**cfg))
                      .view_index(elev, azim))
    from threestudio_3dgs_tpu_torch.guidance.base import PromptProcessorConfig, text_embedding

    pu = PromptUtils("a hamburger", cfg=PromptProcessorConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(pu.view_index(elev, azim), want)
    assert set(want.tolist()) == {0, 1, 2, 3}
    embs = pu.get_text_embeddings(elev, azim)
    assert embs.shape == (len(elev), 77, 1024)
    for i, idx in enumerate(want):
        np.testing.assert_array_equal(embs[i], text_embedding("a hamburger" + VIEW_SUFFIXES[idx]))
    np.testing.assert_array_equal(pu.get_text_embeddings(), text_embedding("a hamburger"))


def test_fuse_lora_matches_jax():
    """peft naming with an alpha, and diffusers naming without one."""
    rng = np.random.default_rng(3)
    base = {"a.to_q.weight": rng.normal(size=(16, 12)), "b.proj.weight": rng.normal(size=(8, 8)),
            "c.weight": rng.normal(size=(4, 4))}
    base = {k: v.astype(np.float32) for k, v in base.items()}
    lora = {
        "a.to_q.lora_A.weight": rng.normal(size=(3, 12)), "a.to_q.lora_B.weight": rng.normal(size=(16, 3)),
        "a.to_q.alpha": np.array(6.0),
        "unet.b.proj.lora.down.weight": rng.normal(size=(2, 8)),
        "unet.b.proj.lora.up.weight": rng.normal(size=(8, 2)),
    }
    lora = {k: np.asarray(v, np.float32) for k, v in lora.items()}
    want = jax_fuse_lora(base, lora, scale=0.7)
    got = pconv.fuse_lora({k: torch.tensor(v) for k, v in base.items()},
                          {k: torch.tensor(v) for k, v in lora.items()}, scale=0.7)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(torch.as_tensor(got[k]).numpy(), want[k], rtol=1e-6, atol=1e-6)
    assert not np.allclose(want["a.to_q.weight"], base["a.to_q.weight"])


@pytest.mark.parametrize("with_dir", [True, False], ids=["tiny_dir", "no_override"])
def test_sd_training_steps_through_launch(tmp_path, with_dir):
    """Two steps of gaussian_splatting.yaml with its own stable-diffusion-
    guidance at 64^2, B=2, tile 16, on the CPU: pointed at a tiny random
    directory (cross-attention width 1024, the prompt embedding's), and
    with no override at all (no local directory: the analytic prior)."""
    overrides = []
    if with_dir:
        unet_cfg = punet.UNet2DConditionConfig(
            block_out_channels=(32, 64), attention_head_dim=(2, 4), cross_attention_dim=1024,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), norm_groups=8)
        vae_cfg = pvae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)
        sd_dir = tmp_path / "sd"
        sizes = pconv.write_random_checkpoint(str(sd_dir), unet_cfg, vae_cfg, seed=0,
                                              device="cpu")
        assert len(sizes) == 2 and all(v > 0 for v in sizes.values())
        overrides = [f"system.guidance.pretrained_model_name_or_path={sd_dir}"]
    trainer = launch.main([
        "--config", PORT_CONFIG, "--train", "--device", "cpu", f"exp_root_dir={tmp_path}",
        "trainer.max_steps=2", "trainer.val_check_interval=0",
        "data.width=64", "data.height=64", "data.batch_size=2",
        "system.geometry.init_num_pts=256", "system.geometry.capacity=1536",
        "system.renderer.tile_size=16",
        # --train ends with the test renders: two, at the training size
        "data.eval_height=64", "data.eval_width=64", "data.n_test_views=2",
    ] + overrides)
    guidance = trainer.system.guidance
    assert isinstance(guidance, StableDiffusionGuidance)
    if with_dir:
        assert guidance.unet.conv_in.weight.dtype == torch.bfloat16  # half_precision_weights
    else:
        assert guidance.unet is None and guidance.denoiser is None
    rows = trainer.metrics_log
    assert len(rows) == 2
    for row in rows:
        assert all(np.isfinite(v) for k, v in row.items() if k.startswith("train/")), row
        assert row["train/grad_norm"] > 0


def test_state_dict_files(tmp_path, monkeypatch):
    """.bin through torch.load(weights_only=True), lightning nesting
    unwrapped; .safetensors without its package raises and says so."""
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "model.bin")
    got = pconv.load_torch_state_dict(str(tmp_path / "model.bin"))
    assert set(got) == {"a.weight"} and torch.equal(got["a.weight"], sd["a.weight"])
    monkeypatch.setitem(__import__("sys").modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        pconv.load_torch_state_dict(str(tmp_path / "model.safetensors"))
