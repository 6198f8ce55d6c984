"""System base: training orchestration (port of the JAX package's
``systems/base.py``).

A system owns the component objects (geometry wrapper, renderer, guidance)
and runs one training step as plain torch under autograd:

    (SystemState, batch, step, generator) -> (SystemState', logs)

Scheduled hyperparameters (per-group learning rates, color_clip, loss
lambdas, the SDS timestep window) are evaluated on the host with C() each
step.  A (B, CAP, 2) zeros tensor that requires grad is added to the screen
positions of every view; its gradient is the means2d side channel whose
norms feed the densification statistics.  The extra parameters (the neural
background's MLP, ``extra_params["background"]``) take their own Adam step
(eps 1e-8) at ``extra_lr``.  The geometry steps its own params
(``apply_gradients``), keeps its densify statistics (``accumulate_stats``)
and ends the step with the structural update when one is due
(``update_states``, its draws from the step's generator).  Evaluation
renders views without gradients (the background parameters included) and
saves validation PNGs.

With the renderer's ``adaptive_max_pairs`` on, the train step sizes the
per-view pair capacity the renderer takes (``max_pairs_override``, in
eval renders too) with the JAX package's bucketed controller: the step's
peak per-view pair demand and its dropped pairs are logged each step, and
every ``_ADAPT_EVERY`` steps the capacity grows on any drop and shrinks
with hysteresis and a cooldown.  As in the JAX package only the systems
whose step is this base step run it (``adapts_pair_capacity``): the
zero123 family (image-to-3D, 4D, SuGaR) keeps ``max_pairs``.

With a mesh (``set_mesh``, from the trainer in a multi-rank run or with
``trainer.devices`` >= 1) the base step runs camera-sharded over the mesh's
ranks (``parallel/data_parallel.py``): ``local_gradients`` on this rank's
shard, the reductions, then ``finish_step``, the same tail as the
one-process step.  Only the base step shards (``shards_camera_batch``).

Every system's step passes through the spans of ``utils/tracing.py``
opened here: ``system/loss`` around ``forward_loss`` (``system/render``
around each ``render_batch``, the guidance's ``system/guidance`` inside
it), ``system/backward`` around the gradients, ``system/update`` around
the optimizers and ``system/densify`` around the statistics, the
capacity controller and the structural update."""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import gaussian_field as gf
from ..models.optim import AdamState, adam_update, init_adam
from ..parallel.data_parallel import make_dp_train_step, shard_batch
from ..utils.config import C, C_max, parse_structured
from ..utils.loss import tv_loss
from ..utils.registry import find
from ..utils.saving import save_image_grid
from ..utils.tracing import span


@dataclasses.dataclass
class SystemState:
    gauss: gf.GaussianState
    # {group: {name: tensor}}, e.g. {"background": {"w0": ..., "b0": ...}}
    extra_params: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    # Adam over the extra parameters, keyed "group/name"; None without them
    extra_opt: Optional[AdamState] = None


def flatten_extra(extra: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """{group: {name: t}} -> {"group/name": t}."""
    return {f"{group}/{name}": t for group, leaves in extra.items() for name, t in leaves.items()}


def unflatten_extra(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    extra: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        group, name = key.split("/", 1)
        extra.setdefault(group, {})[name] = t
    return extra


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
    # whether train_step runs the adaptive pair-capacity controller
    adapts_pair_capacity = True
    _ADAPT_EVERY = 50  # steps between adaptations
    _BUCKET = 256 * 1024  # capacity quantum
    _SHRINK_COOLDOWN = 8 * _ADAPT_EVERY  # least steps between two shrinks
    # whether train_step is this base step, which the dp routing shards
    shards_camera_batch = True

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
            find(cfg.prompt_processor_type)(cfg.prompt_processor, device=self.device)
            if cfg.prompt_processor_type else None
        )
        self.prompt_utils = self.prompt_processor() if self.prompt_processor else None
        # the JAX package's rule as written: optimizer.args.lr, when set,
        # takes precedence over optimizer.params.background.lr
        opt = cfg.optimizer if isinstance(cfg.optimizer, dict) else {}
        self.extra_lr = float(
            (opt.get("args") or {}).get("lr")
            or ((opt.get("params") or {}).get("background") or {}).get("lr")
            or 1e-3
        )
        self._capacity: Optional[int] = None  # the adaptive pair capacity
        # (demand, dropped) of each step since the last adaptation
        self._pair_log: List[tuple] = []
        self._retrace_count = 0  # capacity changes, as the JAX package counts them
        self._last_shrink_step = -(10**9)
        self.mesh = None  # the data-parallel mesh (set_mesh)
        self._dp_axis = "data"
        self._dp_steps: Dict[tuple, Any] = {}  # ("dp", ranks with a shard, batch) -> step

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0) -> SystemState:
        """The geometry's initial field and, with a background that has
        parameters, those parameters (drawn from a generator seeded with
        ``seed`` on the system's device) and their zeroed Adam moments."""
        gauss = self.geometry.init_state(seed)
        extra: Dict[str, Dict[str, torch.Tensor]] = {}
        if self.background is not None:
            params = self.background.init_params(
                torch.Generator(device=self.device).manual_seed(seed))
            if params:
                extra["background"] = params
        return SystemState(gauss=gauss, extra_params=extra,
                           extra_opt=init_adam(flatten_extra(extra)) if extra else None)

    # -- scheduled scalars ---------------------------------------------------
    def loss_lambda(self, sched, name: str) -> float:
        return sched["lambdas"].get(name, 0.0)

    def tv_trio_losses(self, out, sched, logs, loss=None) -> torch.Tensor:
        """The rgb / depth / normal total-variation regularisers under the
        reference's lambda names, added to ``loss``."""
        total = torch.zeros((), device=self.device) if loss is None else loss
        for lam, key_name, log_name in (("lambda_rgb_tv", "comp_rgb", "rgb_tv"),
                                        ("lambda_depth_tv", "comp_depth", "depth_tv"),
                                        ("lambda_normal_tv", "comp_normal", "normal_tv")):
            if self.has_loss(lam) and key_name in out:
                v = tv_loss(out[key_name])
                logs[f"train/loss_{log_name}"] = v
                total = total + v * self.loss_lambda(sched, lam)
        return total

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
        if self.material is not None and hasattr(self.material.cfg, "ambient_only_steps"):
            sched["ambient_only"] = step < self.material.cfg.ambient_only_steps
        return sched

    # -- losses (overridden per system) -------------------------------------
    def compute_loss(self, out, gauss, batch, sched, generator):
        raise NotImplementedError

    # -- forward ------------------------------------------------------------
    def render_batch(self, gauss, extra_params, batch, generator, sched, training,
                     vs_dummy=None, **kwargs):
        """The renderer's ``batch_forward`` of ``batch`` (``kwargs`` passed
        on), inside the ``system/render`` span."""
        with span("system/render"):
            return self.renderer.batch_forward(
                gauss, batch,
                bg_params=extra_params.get("background") if extra_params else None,
                generator=generator, training=training,
                ambient_only=bool(sched.get("ambient_only", False)) if sched else False,
                color_clip=sched["color_clip"] if sched else 1e9,
                means2d_offset=vs_dummy, **kwargs,
            )

    # -- adaptive pair capacity ------------------------------------------------
    def _pair_capacity(self) -> Optional[int]:
        """The per-view capacity the controller sets, None when it is off."""
        rcfg = getattr(self.renderer, "cfg", None)
        if not self.adapts_pair_capacity or not getattr(rcfg, "adaptive_max_pairs", False):
            return None
        if self._capacity is None:
            self._capacity = int(rcfg.max_pairs)
        return self._capacity

    def _adapt_pair_capacity(self, step: int) -> None:
        """Bucketed right-sizing of the per-view pair capacity from the
        steps logged since the last adaptation: grow on any drop to
        bucket(max(1.5 cap, 1.2 demand)); else shrink to bucket(1.4 demand)
        when that is at least two buckets below the capacity and no shrink
        came in the last _SHRINK_COOLDOWN steps.  Buckets are multiples of
        _BUCKET clipped to [min_pairs, max_pairs]."""
        if not self._pair_log or step % self._ADAPT_EVERY != 0:
            return
        demand = max(s[0] for s in self._pair_log)  # peak per-view pair demand
        dropped = max(s[1] for s in self._pair_log)
        self._pair_log.clear()
        rcfg = self.renderer.cfg
        cap = self._capacity

        def bucket(x):
            b = -(-x // self._BUCKET) * self._BUCKET
            return max(min(b, int(rcfg.max_pairs)), int(rcfg.min_pairs))

        if dropped > 0:
            new_cap = bucket(max(int(cap * 3 // 2), int(demand * 1.2)))
        else:
            want = bucket(int(demand * 1.4))
            new_cap = want if want <= cap - 2 * self._BUCKET else cap
            if new_cap < cap and step - self._last_shrink_step < self._SHRINK_COOLDOWN:
                new_cap = cap
        if new_cap != cap:
            if new_cap < cap:
                self._last_shrink_step = step
            self._retrace_count += 1
            print(f"[system] pair capacity {cap} -> {new_cap} (demand {demand}, dropped "
                  f"{dropped}, retrace #{self._retrace_count})", flush=True)
            self._capacity = new_cap

    # -- train step ----------------------------------------------------------
    def forward_loss(self, gs, extra_params, batch, step, sched, generator):
        """The step's renders and loss (overridden per system): returns the
        total loss, the logs, the render outputs in order (the last one's
        radii and visibility feed the densify statistics, and every one's
        pair counts the logs) and ``vs_dummy``, the (B, CAP, 2) screen-space
        offset whose gradient norm those statistics take."""
        bs = int(np.asarray(batch["c2w"]).shape[0])
        vs_dummy = torch.zeros((bs, gs.capacity, 2), device=self.device, requires_grad=True)
        out = self.render_batch(gs, extra_params, batch, generator, sched, True, vs_dummy)
        total, logs = self.compute_loss(out, gs, batch, sched, generator)
        return total, dict(logs), [out], vs_dummy

    def local_gradients(self, state: SystemState, batch: Dict[str, Any], step: int, sched,
                        generator: torch.Generator):
        """The step's loss on ``batch`` and its gradients: (the field's
        gradients by leaf, the extra parameters' by "group/name", the render
        outputs, the (B, CAP) means2d gradient norms, the logs with the
        batch's pair counts: drops summed, the largest per-view demand)."""
        gauss = state.gauss
        leaves = {
            k: v.detach().requires_grad_(True) for k, v in gauss.params.as_dict().items()
        }
        extra = {k: v.detach().requires_grad_(True)
                 for k, v in flatten_extra(state.extra_params).items()}
        gs = dataclasses.replace(gauss, params=dataclasses.replace(gauss.params, **leaves))
        with span("system/loss"):
            total, logs, outs, vs_dummy = self.forward_loss(gs, unflatten_extra(extra), batch,
                                                            step, sched, generator)

        inputs = list(leaves.values()) + list(extra.values()) + [vs_dummy]
        with span("system/backward"):
            grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        g_gauss = dict(zip(leaves.keys(), grads[:len(leaves)]))
        g_extra = dict(zip(extra.keys(), grads[len(leaves):-1]))
        vs_grad_norm = torch.linalg.norm(grads[-1], dim=-1)  # (B, CAP), NDC units
        logs["n_dropped_pairs"] = sum(int(o["n_dropped"].sum()) for o in outs)
        logs["n_pairs_max"] = max(int((o["n_pairs"] + o["n_dropped"]).max()) for o in outs)
        return g_gauss, g_extra, outs, vs_grad_norm, logs

    def finish_step(self, state: SystemState, g_gauss, g_extra, logs, step: int, sched,
                    generator: torch.Generator, capacity: Optional[int],
                    add_stats: Callable) -> tuple:
        """Adam on the field and the extra parameters, the densify
        statistics (``add_stats(gauss)``), the capacity controller and the
        structural update: the part of a step after its gradients, run
        alike by the one-process and the data-parallel steps."""
        with span("system/update"):
            gauss = self.geometry.apply_gradients(state.gauss, g_gauss, sched["lrs"])
            extra_params, extra_opt = state.extra_params, state.extra_opt
            if g_extra:
                params = {k: v.detach() for k, v in flatten_extra(state.extra_params).items()}
                new = adam_update(params, g_extra, extra_opt, {k: self.extra_lr for k in params},
                                  eps=1e-8)
                extra_params = unflatten_extra(new)
        with span("system/densify"):
            gauss = add_stats(gauss)
            if capacity is not None:
                self._pair_log.append((logs["n_pairs_max"], logs["n_dropped_pairs"]))
                self._adapt_pair_capacity(step)
            gauss, _ = self.geometry.update_states(gauss, step, generator)
        return SystemState(gauss=gauss, extra_params=extra_params, extra_opt=extra_opt), logs

    def train_step(self, state: SystemState, batch: Dict[str, Any], step: int,
                   generator: torch.Generator):
        if self.mesh is not None and self.shards_camera_batch:
            return self._dp_step(state, batch, step, generator)
        sched = self.sched_scalars(step)
        capacity = self._pair_capacity()
        self.renderer.max_pairs_override = capacity
        g_gauss, g_extra, outs, vs_grad_norm, logs = self.local_gradients(state, batch, step,
                                                                          sched, generator)
        return self.finish_step(
            state, g_gauss, g_extra, logs, step, sched, generator, capacity,
            add_stats=lambda gauss: self.geometry.accumulate_stats(
                gauss, outs[-1]["radii"].float(), outs[-1]["visibility_filter"], vs_grad_norm))

    # -- data parallel ---------------------------------------------------------
    def set_mesh(self, mesh, axis: str = "data") -> None:
        """Route training through the camera-sharded data-parallel step
        over ``mesh``'s ``axis`` (the trainer calls it when the process
        group has more than one rank, or ``trainer.devices`` asks for one).
        A step whose camera batch the group's size does not divide shards
        over gcd(batch, ranks) of them, the others stepping a copy of a
        shard with zero weight (``make_dp_train_step``).  A system whose
        ``train_step`` is not this base step (the zero123 family) runs
        unsharded and identical on every rank, as the JAX package's ignore
        the mesh."""
        self.mesh = mesh
        self._dp_axis = axis
        self._dp_steps.clear()
        if not self.shards_camera_batch:
            print(f"[system] {type(self).__name__} steps unsharded: every rank runs the whole "
                  f"camera batch", flush=True)

    def _dp_step(self, state, batch, step, generator):
        """This rank's shard through the cached dp step for its batch size."""
        group = self.mesh.get_group(self._dp_axis)
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        bs = int(np.asarray(batch["c2w"]).shape[0])
        use = math.gcd(bs, world)
        key = ("dp", use, bs)
        if key not in self._dp_steps:
            if use != world:
                # surface the idle ranks: bs=2 on 4 ranks silently runs 2
                print(f"[system] camera batch {bs} not divisible by mesh size {world}: "
                      f"stepping on a {use}-device sub-mesh ({world - use} idle)", flush=True)
            self._dp_steps[key] = make_dp_train_step(self, group, bs, n_shards=use)
        # the whole batch's render draws, in the one-process step's order:
        # a view's draws do not depend on the rank that renders it (the JAX
        # package folds the view index into its key)
        batch = dict(batch, **self.renderer.batch_view_draws(generator, bs))
        shard = shard_batch(batch, rank % use, use, bs)
        return self._dp_steps[key](state, shard, step, generator)

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def render_views(self, state: SystemState, views: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """One eval render per view (the background always inverted, no
        draws), each output brought to the host as numpy."""
        outs = []
        for view in views:
            out = self.render_batch(state.gauss, state.extra_params, view, None, None, False)
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
