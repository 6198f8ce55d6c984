"""Score-distillation core math (port of the JAX package's
``guidance/sds.py``: the alphas schedule, the scheduled timestep window and
the reparameterised SDS loss).

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


def sds_loss(
    latents: torch.Tensor,  # (B, ...) differentiable render
    denoise_fn: Callable,  # (noisy, t) -> (eps_uncond, eps_cond)
    generator: torch.Generator,
    sched: dict,
    cfg: SDSConfig,
    alphas_cumprod: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """``t`` and ``noise`` are drawn from ``generator`` unless given (tests
    feed the JAX package's draws)."""
    b = latents.shape[0]
    device = latents.device
    if t is None:
        t = torch.randint(sched["min_step"], sched["max_step"] + 1, (b,),
                          generator=generator, device=generator.device)
    t = t.to(device)
    alpha_bar = alphas_cumprod.to(device)[t].reshape((b,) + (1,) * (latents.dim() - 1))
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=generator.device)
    noise = noise.to(device)
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
