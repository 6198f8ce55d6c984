"""Uniform draws of the renderer's stochastic parts (the kernel
background's inversion, the neural background's augmentation, the
material's shading): from the step's generator, or from the test-only
``draws`` dict, which feeds the JAX package's draws in."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def uniforms(draws: Optional[Dict[str, Any]], name: str, n: int,
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(n,) f32 on ``device``: ``draws[name]`` when given, else n uniforms
    in [0, 1) from ``generator``."""
    if draws and name in draws:
        return torch.as_tensor(draws[name], dtype=torch.float32).reshape(n).to(device)
    return torch.rand((n,), generator=generator, device=generator.device).to(device)
