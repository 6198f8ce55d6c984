"""System base: training orchestration (port of the JAX package's
``systems/base.py``).

A system owns the component objects (geometry wrapper, renderer, guidance)
and runs one training step as plain torch under autograd:

    (SystemState, batch, step, generator) -> (SystemState', logs)

Scheduled hyperparameters (per-group learning rates, color_clip, loss
lambdas, the SDS timestep window) are evaluated on the host with C() each
step.  A (B, CAP, 2) zeros tensor that requires grad is added to the screen
positions of every view; its gradient is the means2d side channel whose
norms feed the densification statistics.  The step ends with the
structural update when one is due (its draws from the step's generator).
Evaluation renders views without gradients and saves validation PNGs."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import gaussian_field as gf
from ..utils.config import C, C_max, parse_structured
from ..utils.registry import find
from ..utils.saving import save_image_grid


@dataclasses.dataclass
class SystemState:
    gauss: gf.GaussianState
    extra_params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BaseSystemConfig:
    geometry_type: str = "gaussian-splatting"
    geometry: dict = dataclasses.field(default_factory=dict)
    geometry_convert_from: str = ""
    material_type: Optional[str] = None
    material: dict = dataclasses.field(default_factory=dict)
    background_type: Optional[str] = None
    background: dict = dataclasses.field(default_factory=dict)
    renderer_type: str = "diff-gaussian-rasterizer"
    renderer: dict = dataclasses.field(default_factory=dict)
    guidance_type: str = "fake-sds-guidance"
    guidance: dict = dataclasses.field(default_factory=dict)
    prompt_processor_type: str = "dummy-prompt-processor"
    prompt_processor: dict = dataclasses.field(default_factory=dict)
    exporter_type: str = "gaussian-mesh-exporter"
    exporter: dict = dataclasses.field(default_factory=dict)
    loss: dict = dataclasses.field(default_factory=dict)
    optimizer: dict = dataclasses.field(default_factory=dict)
    freq: dict = dataclasses.field(default_factory=dict)
    visualize_samples: bool = False


class BaseGaussianSystem:
    Config = BaseSystemConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = self.Config(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(self.Config, cfg)
        self.cfg = cfg
        self.device = torch.device(device)

        geo_cfg = dict(cfg.geometry)
        if cfg.geometry_convert_from and "geometry_convert_from" not in geo_cfg:
            geo_cfg["geometry_convert_from"] = cfg.geometry_convert_from
        self.geometry = find(cfg.geometry_type)(geo_cfg, device=self.device)
        self.material = find(cfg.material_type)(cfg.material) if cfg.material_type else None
        self.background = (
            find(cfg.background_type)(cfg.background) if cfg.background_type else None
        )
        self.renderer = find(cfg.renderer_type)(
            cfg.renderer, geometry=self.geometry, material=self.material,
            background=self.background,
        )
        self.guidance = (
            find(cfg.guidance_type)(cfg.guidance, device=self.device) if cfg.guidance_type else None
        )
        self.prompt_processor = (
            find(cfg.prompt_processor_type)(cfg.prompt_processor)
            if cfg.prompt_processor_type else None
        )
        self.prompt_utils = self.prompt_processor() if self.prompt_processor else None

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0) -> SystemState:
        return SystemState(gauss=self.geometry.init_state(seed))

    # -- scheduled scalars ---------------------------------------------------
    def loss_lambda(self, sched, name: str) -> float:
        return sched["lambdas"].get(name, 0.0)

    def has_loss(self, name: str) -> bool:
        """Could this lambda ever be > 0."""
        try:
            return C_max(self.cfg.loss.get(name, 0.0)) > 0
        except TypeError:
            return False

    def sched_scalars(self, step: int) -> Dict[str, Any]:
        sched: Dict[str, Any] = {
            "lrs": self.geometry.lr_tree(step),
            "color_clip": float(np.float32(self.geometry.color_clip(step))),
            "lambdas": {
                name: float(np.float32(C(value, 0, step)))
                for name, value in self.cfg.loss.items()
                if isinstance(value, (int, float, list, tuple))
            },
            "step": step,
        }
        if self.guidance is not None and hasattr(self.guidance, "sched_scalars"):
            sched["guidance"] = self.guidance.sched_scalars(step)
        return sched

    # -- losses (overridden per system) -------------------------------------
    def compute_loss(self, out, gauss, batch, sched, generator):
        raise NotImplementedError

    # -- forward ------------------------------------------------------------
    def render_batch(self, gauss, batch, generator, sched, training, vs_dummy=None):
        return self.renderer.batch_forward(
            gauss, batch, generator=generator, training=training,
            color_clip=sched["color_clip"] if sched else 1e9,
            means2d_offset=vs_dummy,
        )

    # -- train step ----------------------------------------------------------
    def train_step(self, state: SystemState, batch: Dict[str, Any], step: int,
                   generator: torch.Generator):
        sched = self.sched_scalars(step)
        bs = int(np.asarray(batch["c2w"]).shape[0])
        gauss = state.gauss
        leaves = {
            k: v.detach().requires_grad_(True) for k, v in gauss.params.as_dict().items()
        }
        vs_dummy = torch.zeros((bs, gauss.capacity, 2), device=self.device, requires_grad=True)
        gs = dataclasses.replace(gauss, params=gf.GaussianParams(**leaves))
        out = self.render_batch(gs, batch, generator, sched, True, vs_dummy)
        total, logs = self.compute_loss(out, gs, batch, sched, generator)

        inputs = list(leaves.values()) + [vs_dummy]
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        g_gauss = dict(zip(leaves.keys(), grads[:-1]))
        gauss = gf.apply_gradients(gauss, g_gauss, sched["lrs"])
        vs_grad_norm = torch.linalg.norm(grads[-1], dim=-1)  # (B, CAP), NDC units
        gauss = gf.accumulate_stats(
            gauss, out["radii"].float(), out["visibility_filter"], vs_grad_norm
        )
        logs = dict(logs)
        logs["n_dropped_pairs"] = int(out["n_dropped"].sum())
        logs["n_pairs_max"] = int((out["n_pairs"] + out["n_dropped"]).max())
        gauss, _ = self.geometry.update_states(gauss, step, generator)
        return SystemState(gauss=gauss, extra_params=state.extra_params), logs

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def render_views(self, state: SystemState, views: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """One eval render per view (the background always inverted, no
        draws), each output brought to the host as numpy."""
        outs = []
        for view in views:
            out = self.render_batch(state.gauss, view, None, None, False)
            outs.append({k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                         for k, v in out.items()})
        return outs

    def save_validation_images(self, out_dir, state, views, step, prefix=""):
        outs = self.render_views(state, views)
        for view, out in zip(views, outs):
            imgs = [out["comp_rgb"][0]]
            if "comp_normal" in out:
                imgs.append(out["comp_normal"][0])
            save_image_grid(os.path.join(out_dir, f"it{step}-{prefix}{view['index']}.png"), imgs)
        return outs
