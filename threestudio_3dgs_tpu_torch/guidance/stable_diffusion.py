"""Stable Diffusion SDS guidance (port of the JAX package's
``guidance/stable_diffusion.py``: ``stable-diffusion-guidance`` and its LoRA
subclass).

With ``pretrained_model_name_or_path`` a local diffusers-layout directory
(``unet/`` and ``vae/``, each a ``config.json`` and
``diffusion_pytorch_model.bin``), the real latent-diffusion denoiser runs:
the 4 views are encoded by the VAE (differentiable, so the SDS gradient
reaches the render), the UNet denoises the CFG pair batch ``[uncond |
cond]`` (uncond context = zeros) under ``torch.no_grad``, and the SDS loss
is taken on the latents.  With ``half_precision_weights`` (the default) the
UNet and the VAE compute in bf16 with f32 norms, and the UNet's long
self-attention runs K5.  Without a local directory an analytic prior (the
clean image is a prompt-derived colour) drives the same SDS plumbing."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from ..utils.config import parse_structured
from ..utils.registry import register
from .base import BaseGuidance
from .sds import SDSConfig, ddpm_alphas_cumprod, sds_loss, sds_sched_scalars


@dataclasses.dataclass
class StableDiffusionGuidanceConfig:
    pretrained_model_name_or_path: str = "stabilityai/stable-diffusion-2-1-base"
    guidance_scale: float = 100.0
    weighting_strategy: str = "sds"
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    grad_clip: Any = None
    half_precision_weights: bool = True
    lora_model_name_or_path: Optional[str] = None  # LoRA subclass
    lora_scale: float = 1.0


def _first_file(root: str, sub: str) -> Optional[str]:
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
        path = os.path.join(root, sub, name)
        if os.path.exists(path):
            return path
    return None


@register("stable-diffusion-guidance")
class StableDiffusionGuidance(BaseGuidance):
    Config = StableDiffusionGuidanceConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = StableDiffusionGuidanceConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(StableDiffusionGuidanceConfig, cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.sds_cfg = SDSConfig(
            guidance_scale=cfg.guidance_scale,
            min_step_percent=cfg.min_step_percent,
            max_step_percent=cfg.max_step_percent,
            grad_clip=cfg.grad_clip,
            weighting_strategy=cfg.weighting_strategy,
        )
        self.alphas_cumprod = ddpm_alphas_cumprod(device=self.device)
        self.unet = None
        self.vae_encoder = None
        self.denoiser = None
        if os.path.isdir(str(cfg.pretrained_model_name_or_path)):
            self.denoiser = self._try_load_local(cfg.pretrained_model_name_or_path)

    def _load(self, module_cls, model_cfg, state_dict):
        """The module of a state dict, frozen on the device in f32 or, with
        ``half_precision_weights``, cast to bf16 with f32 norms."""
        from ..diffusion.convert import load_frozen

        return load_frozen(module_cls, model_cfg, state_dict, self.device,
                           self.cfg.half_precision_weights)

    def _try_load_local(self, path: str):
        """The UNet of a local diffusers directory (and its VAE encoder, if
        any) -> the CFG denoiser; None without ``unet/`` weights."""
        unet_file = _first_file(path, "unet")
        if unet_file is None:
            return None
        from ..diffusion import SD21_UNET, UNet2DCondition
        from ..diffusion.convert import (
            fast_model_config, fuse_lora, load_torch_state_dict, unet_config_from_diffusers_json,
        )

        unet_cfg = SD21_UNET
        cfg_json = os.path.join(path, "unet", "config.json")
        if os.path.isfile(cfg_json):
            unet_cfg = unet_config_from_diffusers_json(cfg_json)
        unet_cfg = fast_model_config(unet_cfg, self.cfg.half_precision_weights)
        sd = load_torch_state_dict(unet_file)
        lora_path = str(self.cfg.lora_model_name_or_path or "")
        if lora_path:
            for cand in (lora_path,
                         os.path.join(lora_path, "pytorch_lora_weights.safetensors"),
                         os.path.join(lora_path, "pytorch_lora_weights.bin")):
                if os.path.isfile(cand):
                    sd = fuse_lora(sd, load_torch_state_dict(cand), self.cfg.lora_scale)
                    break
        self.unet = self._load(UNet2DCondition, unet_cfg, sd)
        del sd
        self._load_local_vae(path)
        unet = self.unet

        def denoiser(noisy, t, emb):
            # CFG pair batch [uncond | cond]; emb (L, D) shared or (B, L, D)
            b = noisy.shape[0]
            ctx_c = emb.expand(b, *emb.shape) if emb.dim() == 2 else emb
            ctxs = torch.cat([torch.zeros_like(ctx_c), ctx_c])
            with torch.no_grad():
                eps = unet(torch.cat([noisy, noisy]), torch.cat([t, t]), ctxs)
            return eps[:b], eps[b:]

        return denoiser

    def _load_local_vae(self, path: str) -> None:
        """Attach the differentiable rgb -> scaled-latent encoder when the
        directory has ``vae/`` weights.  Without them SDS runs on the image
        itself (valid only for a UNet built for image space)."""
        vae_file = _first_file(path, "vae")
        if vae_file is None:
            return
        from ..diffusion import SD_VAE, VAEEncoder
        from ..diffusion.convert import (
            fast_model_config, load_torch_state_dict, vae_config_from_diffusers_json,
        )
        from ..diffusion.vae import vae_half

        vae_cfg = SD_VAE
        cfg_json = os.path.join(path, "vae", "config.json")
        if os.path.isfile(cfg_json):
            vae_cfg = vae_config_from_diffusers_json(cfg_json)
        vae_cfg = fast_model_config(vae_cfg, self.cfg.half_precision_weights)
        self.vae_encoder = self._load(
            VAEEncoder, vae_cfg, vae_half(load_torch_state_dict(vae_file), "encoder"))

    def encode_rgb(self, rgb, generator, latent_noise=None):
        """rgb (B, H, W, 3) in [0, 1] -> scaled latents (B, C, H/8, W/8)."""
        from ..diffusion.vae import sample_latents

        moments = self.vae_encoder((rgb * 2.0 - 1.0).permute(0, 3, 1, 2))
        return sample_latents(moments, self.vae_encoder.cfg.scaling_factor, generator,
                              latent_noise)

    def set_denoiser(self, fn):
        """fn(noisy, t, text_embedding) -> (eps_uncond, eps_cond)."""
        self.denoiser = fn

    def sched_scalars(self, step: int) -> dict:
        return sds_sched_scalars(self.sds_cfg, step)

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None, draws=None):
        """``draws`` ({"t", "noise", "latent_noise"}, each optional) replaces
        the generator's draws; only tests pass it."""
        if generator is None:
            generator = torch.Generator(device=rgb.device).manual_seed(0)
        if sched is None:
            sched = sds_sched_scalars(self.sds_cfg, 0)
        draws = draws or {}
        ac = self.alphas_cumprod.to(rgb.device)

        if self.denoiser is not None:
            emb = prompt_utils.get_text_embeddings(batch.get("elevation"), batch.get("azimuth"))
            emb = torch.as_tensor(emb, dtype=torch.float32, device=rgb.device)

            def denoise_fn(noisy, t):
                return self.denoiser(noisy, t, emb)

            if self.vae_encoder is not None:
                latents = self.encode_rgb(rgb, generator, draws.get("latent_noise"))
            else:
                latents = rgb.permute(0, 3, 1, 2)
        else:
            # analytic prior: the clean image is a prompt-derived colour
            if prompt_utils is not None:
                emb = torch.as_tensor(prompt_utils.get_text_embeddings(), device=rgb.device)
                target = torch.sigmoid(emb.mean(dim=0)[:3])
            else:
                target = torch.full((3,), 0.5, device=rgb.device)
            latents = rgb

            def denoise_fn(noisy, t):
                alpha_bar = ac[t].reshape((t.shape[0],) + (1,) * (noisy.dim() - 1))
                eps = (noisy - torch.sqrt(alpha_bar) * target) / torch.sqrt(1.0 - alpha_bar)
                return eps, eps

        loss, aux = sds_loss(latents, denoise_fn, generator, sched, self.sds_cfg, ac,
                             t=draws.get("t"), noise=draws.get("noise"))
        return {"loss_sds": loss, "grad_norm": aux["grad_norm"]}


@register("stable-diffusion-lora-guidance")
class StableDiffusionLoRAGuidance(StableDiffusionGuidance):
    """LoRA-personalised SD guidance: the adapter named by
    ``lora_model_name_or_path`` is fused into the UNet's weights at load."""
