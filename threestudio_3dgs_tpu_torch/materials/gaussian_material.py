"""Lambertian point-light material (port of the JAX package's
``materials/gaussian_material.py``).

    textureless = clamp(n . normalize(light - x), 0) * diffuse + ambient
    shaded      = clamp(albedo, 0, 1) * textureless

``ambient_ratio`` sets diffuse = 1 - ratio and ambient = ratio; otherwise a
training call with ``soft_shading`` draws diffuse = r, ambient = 1 - r.
``shading`` ("albedo", "textureless", "diffuse") picks one output.  An eval
call (or one with no generator) returns the albedo while ``ambient_only``
holds, the shaded colour after.  A training call draws once for the whole
view: albedo while ``ambient_only`` or when u1 > ``diffuse_prob``, else
textureless when u2 < ``textureless_prob``, else shaded.  The draws come
from the step's generator; the test-only ``draws`` keyword ({"soft": r,
"mode": (u1, u2)}) feeds them in."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.image import normalize_vec
from ..utils.config import parse_structured
from ..utils.draws import uniforms
from ..utils.registry import register


@dataclasses.dataclass
class GaussianMaterialConfig:
    ambient_light_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse_light_color: Tuple[float, float, float] = (0.9, 0.9, 0.9)
    ambient_only_steps: int = 1000
    diffuse_prob: float = 0.75
    textureless_prob: float = 0.5
    soft_shading: bool = False


@register("gaussian-diffuse-with-point-light-material")
class GaussianDiffuseWithPointLightMaterial:
    Config = GaussianMaterialConfig
    requires_normal = True

    def __init__(self, cfg=None, **kwargs):
        if cfg is None:
            cfg = GaussianMaterialConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(GaussianMaterialConfig, cfg)
        self.cfg = cfg

    def shade(
        self,
        positions: torch.Tensor,  # (..., 3)
        shading_normal: torch.Tensor,  # (..., 3)
        light_positions: torch.Tensor,  # (..., 3) or (3,)
        albedo: torch.Tensor,  # (..., 3)
        generator: Optional[torch.Generator] = None,
        ambient_only: bool = False,
        training: bool = False,
        ambient_ratio: Optional[float] = None,
        shading: Optional[str] = None,
        draws: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        device = albedo.device
        random = training and (generator is not None or bool(draws))
        amb = torch.tensor(cfg.ambient_light_color, dtype=torch.float32, device=device)
        dif = torch.tensor(cfg.diffuse_light_color, dtype=torch.float32, device=device)
        if ambient_ratio is not None:
            dif = torch.full_like(dif, 1.0 - ambient_ratio)
            amb = torch.full_like(amb, ambient_ratio)
        elif random and cfg.soft_shading:
            dif = uniforms(draws, "soft", 1, generator, device).expand(3)
            amb = 1.0 - dif

        light_dirs = normalize_vec(light_positions - positions)
        diffuse_light = torch.clamp_min(
            torch.sum(shading_normal * light_dirs, dim=-1, keepdim=True), 0.0) * dif
        textureless = diffuse_light + amb
        shaded = torch.clamp(albedo, 0.0, 1.0) * textureless

        if shading == "albedo":
            return albedo
        if shading == "textureless":
            return textureless
        if shading == "diffuse":
            return shaded
        if not random:
            return albedo if ambient_only else shaded
        u1, u2 = uniforms(draws, "mode", 2, generator, device)
        use_albedo = (u1 > cfg.diffuse_prob) | ambient_only
        lit = torch.where(u2 < cfg.textureless_prob, textureless.expand_as(shaded), shaded)
        return torch.where(use_albedo, albedo, lit)
