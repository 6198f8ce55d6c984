"""Neural environment-map background (port of the JAX package's
``backgrounds/neural_env.py``): the real SH basis of the ray directions
(degree ``sh_degree - 1``, so ``sh_degree``^2 features), an MLP of
``n_hidden_layers`` ReLU layers of ``n_neurons``, then a sigmoid.

The parameters are a dict of tensors kept in the system's state
(``SystemState.extra_params["background"]``), not in this object.  With
``random_aug`` a training call replaces the whole view's colour, with
probability ``random_aug_prob``, by black or white (one draw each from the
step's generator); the test-only ``draws`` keyword feeds the draws in."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.sh import sh_basis
from ..utils.config import parse_structured
from ..utils.draws import uniforms
from ..utils.registry import register


@dataclasses.dataclass
class NeuralEnvBackgroundConfig:
    color_activation: str = "sigmoid"  # the only activation of the reference configs
    n_output_dims: int = 3
    sh_degree: int = 3
    n_neurons: int = 16
    n_hidden_layers: int = 2
    random_aug: bool = False
    random_aug_prob: float = 0.5
    eval_color: Optional[Tuple[float, float, float]] = None
    share_aug_bg: bool = False  # read and ignored, as in the JAX package


@register("gaussian-mvdream-neural-environment-map-background")
class NeuralEnvironmentMapBackground:
    Config = NeuralEnvBackgroundConfig

    def __init__(self, cfg=None, **kwargs):
        if cfg is None:
            cfg = NeuralEnvBackgroundConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(NeuralEnvBackgroundConfig, cfg)
        if cfg.color_activation != "sigmoid":
            raise ValueError(
                f"color_activation {cfg.color_activation!r}: only sigmoid is supported")
        self.cfg = cfg
        self.in_dim = cfg.sh_degree ** 2

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn
        from ``generator`` on its device."""
        cfg = self.cfg
        dims = [self.in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.n_output_dims]
        device = generator.device
        params = {}
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{i}"] = torch.randn((din, dout), generator=generator, device=device) \
                * (2.0 / din) ** 0.5
            params[f"b{i}"] = torch.zeros(dout, device=device)
        return params

    def __call__(self, params: Dict[str, Any], dirs: torch.Tensor,
                 generator: Optional[torch.Generator] = None, training: bool = False,
                 draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """(..., 3) ray directions -> (..., 3) colour.  ``draws``
        {"bg_aug": (u_use, u_value)} replaces the generator's two uniforms."""
        cfg = self.cfg
        if not training and cfg.eval_color is not None:
            color = torch.tensor(cfg.eval_color, dtype=torch.float32, device=dirs.device)
            return color.expand(dirs.shape[:-1] + (3,))
        x = sh_basis(dirs, cfg.sh_degree - 1)
        n_layers = cfg.n_hidden_layers + 1
        for i in range(n_layers):
            x = x @ params[f"w{i}"] + params[f"b{i}"]
            if i < n_layers - 1:
                x = torch.relu(x)
        color = torch.sigmoid(x)
        if training and cfg.random_aug and (generator is not None or draws):
            u_use, u_value = uniforms(draws, "bg_aug", 2, generator, dirs.device)
            value = (u_value < 0.5).float()
            color = torch.where(u_use < cfg.random_aug_prob, value.expand_as(color), color)
        return color
