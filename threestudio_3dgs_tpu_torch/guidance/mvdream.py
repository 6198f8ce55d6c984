"""MVDream / ImageDream multi-view diffusion SDS guidance (port of the JAX
package's ``guidance/mvdream.py``: ``mvdream-multiview-diffusion-guidance``
and ``multiview-diffusion-guidance``).

  * camera conditioning: each view's c2w with its translation scaled to
    unit length, flattened to 16 features;
  * one diffusion timestep per scene of ``n_view`` consecutive views;
  * CFG over the pair batch [uncond | cond] whose unconditional context is
    zeros, the views of a scene consecutive in each half, so the UNet's 3D
    self-attention sees whole scenes;
  * ``recon_loss`` (the reference configs' mode): ``sds_recon_loss``;
    otherwise the reparameterised SDS of ``sds_loss``.

With ``pretrained_model_name_or_path`` (or ``ckpt_path``) a local
directory whose ``unet/`` holds weights, the multi-view UNet
(``MVDREAM_UNET`` with ``num_views = n_view``, its ``config.json`` unread,
as in the JAX package) and, with ``vae/`` weights, the SD VAE encoder run
in f32, as the JAX guidance builds them; on the card the UNet's long
self-attention takes K5's f32 kernel.  The renders are resized to
``image_size`` first (bilinear, antialiased when downsampling, as
``jax.image.resize`` is).  Without such a directory an analytic prior (the
clean image is a prompt-derived colour) drives the same multi-view SDS.
``ip_mode`` (ImageDream's image prompt) is read and ignored, as in the JAX
package."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..utils.config import parse_structured
from ..utils.registry import register
from .base import BaseGuidance
from .sds import SDSConfig, ddpm_alphas_cumprod, sds_loss, sds_recon_loss, sds_sched_scalars
from .stable_diffusion import _first_file


@dataclasses.dataclass
class MultiviewDiffusionGuidanceConfig:
    model_name: str = "sd-v2.1-base-4view"
    ckpt_path: Optional[str] = None
    pretrained_model_name_or_path: str = ""
    guidance_scale: float = 50.0
    grad_clip: Any = None
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    recon_loss: bool = True
    recon_std_rescale: float = 0.5
    n_view: int = 4
    image_size: int = 256
    camera_condition_type: str = "rotation"
    ip_mode: Optional[str] = None  # read and ignored, as in the JAX package
    rgb_as_latents: bool = False


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size): half-pixel bilinear, antialiased
    (a triangle filter widened by the scale) when downsampling, as
    ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


@register("mvdream-multiview-diffusion-guidance")
@register("multiview-diffusion-guidance")
class MultiviewDiffusionGuidance(BaseGuidance):
    Config = MultiviewDiffusionGuidanceConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = MultiviewDiffusionGuidanceConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(MultiviewDiffusionGuidanceConfig, cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.sds_cfg = SDSConfig(
            guidance_scale=cfg.guidance_scale,
            min_step_percent=cfg.min_step_percent,
            max_step_percent=cfg.max_step_percent,
            grad_clip=cfg.grad_clip,
        )
        self.alphas_cumprod = ddpm_alphas_cumprod(device=self.device)
        self.unet = None
        self.vae_encoder = None
        self.denoiser = None
        path = str(cfg.ckpt_path or cfg.pretrained_model_name_or_path or "")
        if os.path.isdir(path):
            self._load_local(path)

    def _load_local(self, path: str) -> None:
        """The multi-view UNet (and the VAE encoder) of a local diffusers
        directory; the analytic prior stays without ``unet/`` weights."""
        from ..diffusion import MVDREAM_UNET, SD_VAE, UNet2DCondition, VAEEncoder
        from ..diffusion.convert import load_frozen, load_torch_state_dict
        from ..diffusion.vae import vae_half

        unet_file = _first_file(path, "unet")
        if unet_file is None:
            return
        ucfg = dataclasses.replace(MVDREAM_UNET, num_views=self.cfg.n_view)
        self.unet = load_frozen(UNet2DCondition, ucfg, load_torch_state_dict(unet_file),
                                self.device)
        unet = self.unet

        def denoiser(noisy, t, context, camera):
            # CFG pair batch [uncond | cond], each half scene-major
            b = noisy.shape[0]
            uncond, cond = context  # (L, D) each
            ctx = torch.cat([uncond.expand(b, *uncond.shape), cond.expand(b, *cond.shape)])
            with torch.no_grad():
                eps = unet(torch.cat([noisy, noisy]), torch.cat([t, t]), ctx,
                           torch.cat([camera, camera]))
            return eps[:b], eps[b:]

        self.denoiser = denoiser
        vae_file = _first_file(path, "vae")
        if vae_file is not None:
            self.vae_encoder = load_frozen(VAEEncoder, SD_VAE,
                                           vae_half(load_torch_state_dict(vae_file), "encoder"),
                                           self.device)

    def encode_rgb(self, rgb, generator, latent_noise=None):
        """rgb (B, H, W, 3) in [0, 1] -> scaled latents (B, 4, s/8, s/8) of
        the render resized to s = ``image_size``."""
        from ..diffusion.vae import sample_latents

        x = resize_bilinear((rgb * 2.0 - 1.0).permute(0, 3, 1, 2), self.cfg.image_size)
        return sample_latents(self.vae_encoder(x), self.vae_encoder.cfg.scaling_factor,
                              generator, latent_noise)

    def camera_condition(self, batch, b: int, device) -> torch.Tensor:
        """(B, 16): each view's c2w with unit-length translation, flattened
        (MVDream's ``camera_condition_type: rotation``)."""
        c2w = batch.get("c2w")
        if c2w is None:
            return torch.zeros((b, 16), device=device)
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device).clone()
        trans = c2w[:, :3, 3]
        c2w[:, :3, 3] = trans / (torch.linalg.norm(trans, dim=-1, keepdim=True) + 1e-8)
        return c2w.reshape(c2w.shape[0], 16)

    def sched_scalars(self, step: int) -> dict:
        return sds_sched_scalars(self.sds_cfg, step)

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None, draws=None):
        """``draws`` ({"t" per scene, "noise", "latent_noise"}, each
        optional) replaces the generator's draws; only tests pass it."""
        if generator is None:
            generator = torch.Generator(device=rgb.device).manual_seed(0)
        if sched is None:
            sched = sds_sched_scalars(self.sds_cfg, 0)
        draws = draws or {}
        ac = self.alphas_cumprod.to(rgb.device)
        n_view = self.cfg.n_view

        if self.denoiser is not None:
            emb = torch.as_tensor(prompt_utils.get_text_embeddings(), dtype=torch.float32,
                                  device=rgb.device)
            context = (torch.zeros_like(emb), emb)
            camera = self.camera_condition(batch, rgb.shape[0], rgb.device)
            if self.vae_encoder is not None and not self.cfg.rgb_as_latents:
                latents = self.encode_rgb(rgb, generator, draws.get("latent_noise"))
            else:
                x = resize_bilinear((rgb * 2.0 - 1.0).permute(0, 3, 1, 2),
                                    self.cfg.image_size // 8)
                latents = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)

            def denoise_fn(noisy, t):
                return self.denoiser(noisy, t, context, camera)
        else:
            # analytic prior in pixel space; the multi-view timestep sharing
            # still runs for real
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

        kw = dict(t=draws.get("t"), noise=draws.get("noise"), n_view=n_view)
        if self.cfg.recon_loss:
            loss, aux = sds_recon_loss(latents, denoise_fn, generator, sched, self.sds_cfg, ac,
                                       recon_std_rescale=self.cfg.recon_std_rescale, **kw)
        else:
            loss, aux = sds_loss(latents, denoise_fn, generator, sched, self.sds_cfg, ac, **kw)
        return {"loss_sds": loss, "grad_norm": aux["grad_norm"]}
