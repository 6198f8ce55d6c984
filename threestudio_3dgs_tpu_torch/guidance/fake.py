"""Deterministic fake guidances (port of the JAX package's
``fake-sds-guidance``, ``fake-mse-guidance`` and
``analytic-scene-sds-guidance``), so no diffusion checkpoint is needed: an
analytic denoiser whose clean image is a fixed target colour, run through
the real SDS plumbing; the plain squared error to that colour, summed over
the pixels of a view; and per-view targets ray-traced from a fixed scene
of spheres, pulled at directly ("mse") or through the SDS plumbing
("sds")."""

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

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None):
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

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None):
        target = torch.tensor(self.cfg.target_color, dtype=torch.float32, device=rgb.device)
        return {"loss_sds": torch.mean((rgb - target) ** 2) * rgb.shape[1] * rgb.shape[2]}


@dataclasses.dataclass
class AnalyticSceneGuidanceConfig:
    guidance_scale: float = 3.0
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    grad_clip: Any = None
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # "mse" pulls straight at the target images; "sds" routes the same
    # targets through the SDS plumbing
    mode: str = "sds"


@register("analytic-scene-sds-guidance")
class AnalyticSceneSDSGuidance(BaseGuidance):
    """Multi-view consistent image targets: each view's target is an exact
    ray-traced render (closed-form sphere hits, Lambertian shade) of a
    fixed snowman of eight spheres, computed from the batch's
    ``rays_o``/``rays_d``, so the views agree in 3D.  No weights."""

    Config = AnalyticSceneGuidanceConfig

    # (centre xyz, radius, albedo rgb)
    SPHERES = (
        ((0.0, 0.0, -0.22), 0.34, (0.95, 0.95, 0.98)),  # body
        ((0.0, 0.0, 0.18), 0.24, (0.92, 0.92, 0.96)),  # torso
        ((0.0, 0.0, 0.47), 0.15, (0.90, 0.88, 0.92)),  # head
        ((0.06, -0.13, 0.51), 0.025, (0.05, 0.05, 0.08)),  # eye L
        ((-0.06, -0.13, 0.51), 0.025, (0.05, 0.05, 0.08)),  # eye R
        ((0.0, -0.15, 0.45), 0.035, (0.95, 0.45, 0.10)),  # carrot nose
        ((0.0, -0.2, 0.18), 0.04, (0.75, 0.10, 0.10)),  # button 1
        ((0.0, -0.24, 0.03), 0.04, (0.75, 0.10, 0.10)),  # button 2
    )
    LIGHT_DIR = (0.45, -0.6, 0.66)

    def __init__(self, cfg=None, device=None, **kwargs):
        # device: unused, the targets are computed wherever the rays lie
        if cfg is None:
            cfg = AnalyticSceneGuidanceConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(AnalyticSceneGuidanceConfig, cfg)
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

    def target_images(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) rays -> (B, H, W, 3) ray-traced targets: the nearest
        sphere hit past 1e-3, shaded 0.35 + 0.65 max(n . light, 0), else the
        background colour."""
        device = rays_o.device

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        best_t = torch.full(rays_o.shape[:-1], float("inf"), device=device)
        color = vec(self.cfg.bg_color).expand(rays_o.shape)
        light = vec(self.LIGHT_DIR)
        light = light / torch.linalg.norm(light)
        for c, r, alb in self.SPHERES:
            c = vec(c)
            oc = rays_o - c
            b = torch.sum(oc * d, dim=-1)
            disc = b * b - (torch.sum(oc * oc, dim=-1) - r * r)
            t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
            hit = (disc > 0) & (t > 1e-3) & (t < best_t)
            n = (rays_o + t[..., None] * d - c) / r
            shade = 0.35 + 0.65 * torch.clamp_min(torch.sum(n * light, dim=-1), 0.0)
            color = torch.where(hit[..., None], vec(alb) * shade[..., None], color)
            best_t = torch.where(hit, t, best_t)
        return color

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None, draws=None):
        """``draws`` ({"t", "noise"}, each optional) replaces the
        generator's draws in "sds" mode; only tests pass it."""
        targets = self.target_images(torch.as_tensor(batch["rays_o"], device=rgb.device),
                                     torch.as_tensor(batch["rays_d"], device=rgb.device))
        if self.cfg.mode == "mse":
            return {"loss_sds": 0.5 * torch.sum((rgb - targets) ** 2) / rgb.shape[0]}
        ac = self.alphas_cumprod.to(rgb.device)

        def denoise_fn(noisy, t):
            alpha_bar = ac[t].reshape((t.shape[0],) + (1,) * (noisy.dim() - 1))
            eps = (noisy - torch.sqrt(alpha_bar) * targets) / torch.sqrt(1.0 - alpha_bar)
            return eps, eps

        if generator is None:
            generator = torch.Generator(device=rgb.device).manual_seed(0)
        if sched is None:
            sched = sds_sched_scalars(self.sds_cfg, 0)
        draws = draws or {}
        loss, aux = sds_loss(rgb, denoise_fn, generator, sched, self.sds_cfg, ac,
                             t=draws.get("t"), noise=draws.get("noise"))
        return {"loss_sds": loss, "grad_norm": aux["grad_norm"]}
