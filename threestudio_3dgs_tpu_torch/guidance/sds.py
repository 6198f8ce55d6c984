"""Score-distillation core math (port of the JAX package's
``guidance/sds.py``: the alphas schedule, the scheduled timestep window,
the reparameterised SDS loss and MVDream's reconstruction loss, each with
one timestep per scene of ``n_view`` views).

    grad = w(t) * (eps_pred - eps)               (no gradient)
    target = latents - grad                      (no gradient)
    loss_sds = 0.5 * sum((latents - target)^2) / batch

with w(t) = 1 - alpha_bar_t and t uniform in [min_step, max_step]."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..utils.config import C


def ddpm_alphas_cumprod(num_steps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012, device="cpu") -> torch.Tensor:
    """Scaled-linear (sqrt-space) beta schedule of the SD DDIM scheduler."""
    betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_steps,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


@dataclasses.dataclass
class SDSConfig:
    guidance_scale: float = 3.0
    min_step_percent: object = 0.02
    max_step_percent: object = 0.98
    grad_clip: Optional[object] = None
    num_train_timesteps: int = 1000
    weighting_strategy: str = "sds"


def sds_sched_scalars(cfg: SDSConfig, step: int) -> dict:
    """Scheduled SDS knobs for one step."""
    sched = {
        "min_step": int(C(cfg.min_step_percent, 0, step) * cfg.num_train_timesteps),
        "max_step": int(C(cfg.max_step_percent, 0, step) * cfg.num_train_timesteps),
    }
    if cfg.grad_clip is not None:
        sched["grad_clip"] = float(C(cfg.grad_clip, 0, step))
    return sched


def _draw_t_noise(latents, generator, sched, n_view, t, noise):
    """One timestep per scene of ``n_view`` consecutive views, repeated to
    its views, and the noise: drawn from ``generator`` unless given (``t``
    per scene, (B // n_view,))."""
    b = latents.shape[0]
    device = latents.device
    if t is None:
        t = torch.randint(sched["min_step"], sched["max_step"] + 1, (b // n_view,),
                          generator=generator, device=generator.device)
    t = torch.repeat_interleave(t.to(device), n_view)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=generator.device)
    return t, noise.to(device)


def sds_loss(
    latents: torch.Tensor,  # (B, ...) differentiable render
    denoise_fn: Callable,  # (noisy, t) -> (eps_uncond, eps_cond)
    generator: torch.Generator,
    sched: dict,
    cfg: SDSConfig,
    alphas_cumprod: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    n_view: int = 1,
) -> Tuple[torch.Tensor, dict]:
    """``n_view`` > 1: one timestep shared by each scene's views.  ``t``
    (per scene) and ``noise`` are drawn from ``generator`` unless given
    (tests feed the JAX package's draws)."""
    b = latents.shape[0]
    t, noise = _draw_t_noise(latents, generator, sched, n_view, t, noise)
    alpha_bar = alphas_cumprod.to(latents.device)[t].reshape((b,) + (1,) * (latents.dim() - 1))
    noisy = torch.sqrt(alpha_bar) * latents + torch.sqrt(1.0 - alpha_bar) * noise

    eps_uncond, eps_cond = denoise_fn(noisy.detach(), t)
    eps_pred = eps_uncond + cfg.guidance_scale * (eps_cond - eps_uncond)
    if cfg.weighting_strategy == "sds":
        w = 1.0 - alpha_bar
    elif cfg.weighting_strategy == "uniform":
        w = torch.ones_like(alpha_bar)
    elif cfg.weighting_strategy == "fantasia3d":
        w = (alpha_bar**0.5) * (1.0 - alpha_bar)
    else:
        raise ValueError(cfg.weighting_strategy)
    grad = w * (eps_pred - noise)
    if "grad_clip" in sched:
        grad = torch.clamp(grad, -sched["grad_clip"], sched["grad_clip"])
    grad = torch.nan_to_num(grad).detach()
    target = (latents - grad).detach()
    loss = 0.5 * torch.sum((latents - target) ** 2) / b
    aux = {"grad_norm": torch.linalg.norm(grad)}
    return loss, aux


def sds_recon_loss(
    latents: torch.Tensor,  # (B, ...) differentiable latents, B = scenes * n_view
    denoise_fn: Callable,  # (noisy, t) -> (eps_uncond, eps_cond)
    generator: torch.Generator,
    sched: dict,
    cfg: SDSConfig,
    alphas_cumprod: torch.Tensor,
    n_view: int = 4,
    recon_std_rescale: float = 0.5,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """MVDream's reconstruction-mode SDS: denoise to the x0 estimate under
    CFG, pull its per-scene std toward the unguided estimate's by
    ``recon_std_rescale`` (the CFG over-saturation fix), and take 0.5 x the
    per-view sum of squares against it, averaged over views."""
    b = latents.shape[0]
    scenes = b // n_view
    t, noise = _draw_t_noise(latents, generator, sched, n_view, t, noise)
    alpha_bar = alphas_cumprod.to(latents.device)[t].reshape((b,) + (1,) * (latents.dim() - 1))
    noisy = torch.sqrt(alpha_bar) * latents + torch.sqrt(1.0 - alpha_bar) * noise

    eps_uncond, eps_cond = denoise_fn(noisy.detach(), t)
    eps_pred = eps_uncond + cfg.guidance_scale * (eps_cond - eps_uncond)
    sqrt_ab = torch.sqrt(alpha_bar)
    sqrt_1ab = torch.sqrt(1.0 - alpha_bar)
    recon = (noisy - sqrt_1ab * eps_pred) / sqrt_ab
    if recon_std_rescale > 0:
        recon_nocfg = (noisy - sqrt_1ab * eps_cond) / sqrt_ab
        std = torch.std(recon.reshape(scenes, -1), dim=1, correction=0) + 1e-8
        std_nocfg = torch.std(recon_nocfg.reshape(scenes, -1), dim=1, correction=0)
        factor = (std_nocfg / std).reshape((scenes, 1) + (1,) * (latents.dim() - 1))
        adjusted = recon.reshape((scenes, n_view) + latents.shape[1:]) * factor
        adjusted = adjusted.reshape(latents.shape)
        recon = recon_std_rescale * adjusted + (1 - recon_std_rescale) * recon
    target = recon.detach()
    loss = 0.5 * torch.mean(torch.sum((latents - target) ** 2, dim=tuple(range(1, latents.dim()))))
    aux = {"grad_norm": torch.linalg.norm((latents - target).detach())}
    return loss, aux
