"""Deterministic fake guidances (port of the JAX package's
``fake-sds-guidance`` and ``fake-mse-guidance``), so no diffusion
checkpoint is needed: an analytic denoiser whose clean image is a fixed
target colour, run through the real SDS plumbing; and the plain squared
error to that colour, summed over the pixels of a view."""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..utils.config import parse_structured
from ..utils.registry import register
from .base import BaseGuidance
from .sds import SDSConfig, ddpm_alphas_cumprod, sds_loss, sds_sched_scalars


@dataclasses.dataclass
class FakeGuidanceConfig:
    target_color: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    guidance_scale: float = 3.0
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    grad_clip: Any = None


@register("fake-sds-guidance")
class FakeSDSGuidance(BaseGuidance):
    Config = FakeGuidanceConfig

    def __init__(self, cfg=None, device=None, **kwargs):
        # device: unused, the analytic denoiser runs wherever rgb lies
        if cfg is None:
            cfg = FakeGuidanceConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(FakeGuidanceConfig, cfg)
        self.cfg = cfg
        self.sds_cfg = SDSConfig(
            guidance_scale=cfg.guidance_scale,
            min_step_percent=cfg.min_step_percent,
            max_step_percent=cfg.max_step_percent,
            grad_clip=cfg.grad_clip,
        )
        self.alphas_cumprod = ddpm_alphas_cumprod()

    def sched_scalars(self, step: int) -> dict:
        return sds_sched_scalars(self.sds_cfg, step)

    def __call__(self, rgb, prompt_utils, batch, generator=None, sched=None):
        target = torch.tensor(self.cfg.target_color, dtype=torch.float32, device=rgb.device)
        ac = self.alphas_cumprod.to(rgb.device)

        def denoise_fn(noisy, t):
            # eps = (noisy - sqrt(ab) x0) / sqrt(1 - ab) with x0 the target
            alpha_bar = ac[t].reshape((t.shape[0],) + (1,) * (noisy.dim() - 1))
            eps = (noisy - torch.sqrt(alpha_bar) * target) / torch.sqrt(1.0 - alpha_bar)
            return eps, eps  # uncond == cond: guidance mixing is a no-op

        if generator is None:
            generator = torch.Generator(device=rgb.device).manual_seed(0)
        if sched is None:
            sched = sds_sched_scalars(self.sds_cfg, 0)
        loss, aux = sds_loss(rgb, denoise_fn, generator, sched, self.sds_cfg, ac)
        return {"loss_sds": loss, "grad_norm": aux["grad_norm"]}


@register("fake-mse-guidance")
class FakeMSEGuidance(BaseGuidance):
    """mean((rgb - target)^2) x H x W: no noise and no timestep."""

    Config = FakeGuidanceConfig

    def __init__(self, cfg=None, device=None, **kwargs):
        if cfg is None:
            cfg = FakeGuidanceConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(FakeGuidanceConfig, cfg)
        self.cfg = cfg

    def __call__(self, rgb, prompt_utils, batch, generator=None, sched=None):
        target = torch.tensor(self.cfg.target_color, dtype=torch.float32, device=rgb.device)
        return {"loss_sds": torch.mean((rgb - target) ** 2) * rgb.shape[1] * rgb.shape[2]}
