"""Solid-colour background (port of the JAX package's
``backgrounds/solid.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.config import parse_structured
from ..utils.registry import register


@dataclasses.dataclass
class SolidColorBackgroundConfig:
    n_output_dims: int = 3
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    learned: bool = False
    random_aug: bool = False
    random_aug_prob: float = 0.5


@register("solid-color-background")
class SolidColorBackground:
    Config = SolidColorBackgroundConfig

    def __init__(self, cfg=None, **kwargs):
        if cfg is None:
            cfg = SolidColorBackgroundConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(SolidColorBackgroundConfig, cfg)
        self.cfg = cfg

    def init_params(self, generator=None):
        return {}

    def __call__(self, params, dirs, generator=None, training=False, draws=None):
        """``draws`` is accepted for the renderer's interface; this
        background's augmentation draws from ``generator`` only."""
        color = torch.tensor(self.cfg.color, dtype=torch.float32, device=dirs.device)
        out = color.expand(dirs.shape[:-1] + (3,))
        if training and self.cfg.random_aug and generator is not None:
            use = torch.rand((), generator=generator, device=generator.device)
            rand = torch.rand((3,), generator=generator, device=generator.device)
            if float(use) < self.cfg.random_aug_prob:
                out = rand.to(dirs.device).expand(out.shape)
        return out
