"""Video-to-4D system with spacetime Gaussians (port of the JAX package's
``systems/gaussian_4dgen.py``, ``gaussian-splatting-4dgen-system``).

  * stage "static": the image-to-3D step with SuGaR's surface
    regularisers on the reference substep (``systems/sugar_static.py``);
  * stage "motion", per step and in one backward:
      - "zero123": the temporal Zero123 SDS on ``batch["random_camera"]``,
        each view conditioned on its frame (``lambda_sds_zero123``, else
        ``lambda_sds``);
      - "ref": the fixed front camera over the sampled frames, rgb / mask
        MSE (+ the PSNR log);
      - the inter-frame substep where ``freq.inter_frame_reg`` is due: lite
        ARAP between the first and the later of ``num_inter_frames`` times
        in a random window, and the optional 2D-diffusion SDS of their
        reference-camera renders;
      - the regularisers: ``lambda_ref_gs`` anchors the first sampled
        frame's positions to the canonical cloud, and the lite ARAP holds
        the positions at a random time to those at that frame (these and
        the inter-frame substep in the ``system/motion_reg`` span).
The lite ARAP's k-NN table of the live rows (self excluded) is refreshed on
the host every ``freq.update_arap`` steps.  With a deformation network its
parameters are ``extra_params["deformation"]``, trained by the extra Adam.
``attach_video_frames`` hands the data module's frames to the guidance's
``prepare_embeddings``, which builds the real Zero123 denoiser where the
checkpoint is local.

Random draws (the lite ARAP's time, the inter-frame window, SuGaR's
samples) come from the step's generator; the test-only ``step_draws``
(step -> dict) feeds the JAX package's draws in."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.optim import init_adam
from ..ops.arap import arap_energy_knn
from ..utils.draws import uniforms
from ..utils.loss import psnr
from ..utils.registry import find, register
from ..utils.tracing import span
from .base import SystemState, flatten_extra
from .gaussian_zero123 import Zero123System, Zero123SystemConfig
from .sugar_static import GaussianStageRegMixin, alive_knn, build_guidance_2d


@dataclasses.dataclass
class Gaussian4DGenConfig(Zero123SystemConfig):
    stage: str = "motion"  # "static" | "motion"
    num_inter_frames: int = 10
    length_inter_frames: float = 0.2
    guidance_zero123_type: Optional[str] = None
    guidance_zero123: dict = dataclasses.field(default_factory=dict)
    guidance_2d_type: Optional[str] = None
    guidance_2d: dict = dataclasses.field(default_factory=dict)
    prompt_processor_2d_type: Optional[str] = None
    prompt_processor_2d: dict = dataclasses.field(default_factory=dict)
    prompt_processor_3d_type: Optional[str] = None
    guidance_3d_type: Optional[str] = None
    sugar: dict = dataclasses.field(default_factory=dict)


@register("gaussian-splatting-4dgen-system")
class Gaussian4DGenSystem(GaussianStageRegMixin, Zero123System):
    Config = Gaussian4DGenConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        super().__init__(cfg, device, **kwargs)
        cfg = self.cfg
        if cfg.guidance_zero123_type:
            self.guidance = find(cfg.guidance_zero123_type)(cfg.guidance_zero123,
                                                            device=self.device)
        self.guidance_2d, self.prompt_utils_2d = build_guidance_2d(cfg, self.device)
        self._arap_nbrs: Optional[torch.Tensor] = None
        self._arap_step = -(10 ** 9)
        self.arap_k = int(cfg.freq.get("arap_k", 8))
        self._init_sugar_stage(cfg.sugar)
        self.step_draws: Optional[Callable[[int], Dict[str, Any]]] = None

    def init_state(self, seed: int = 0) -> SystemState:
        """The field and, with a deformation network, its parameters
        (drawn from a generator seeded with ``seed + 1``) in the extra
        parameters with zeroed Adam moments."""
        state = super().init_state(seed)
        if getattr(self.geometry.cfg, "enable_deformation", False):
            extra = dict(state.extra_params)
            extra["deformation"] = self.geometry.init_deformation(
                torch.Generator(device=self.device).manual_seed(seed + 1))
            state = SystemState(gauss=state.gauss, extra_params=extra,
                                extra_opt=init_adam(flatten_extra(extra)))
        return state

    def attach_video_frames(self, frames: np.ndarray) -> None:
        if hasattr(self.guidance, "prepare_embeddings"):
            self.guidance.prepare_embeddings(frames)

    # -- the lite ARAP's neighbourhoods ----------------------------------------
    def _refresh_arap(self, state: SystemState, step: int) -> None:
        interval = int(self.cfg.freq.get("update_arap", 500))
        if self._arap_nbrs is not None and step - self._arap_step < interval:
            return
        gauss = state.gauss
        self._arap_nbrs = alive_knn(gauss.params.xyz.detach(), gauss.alive, self.arap_k,
                                    exclude_self=True)
        self._arap_step = step

    def _lite_arap(self, gs, rest: torch.Tensor, deformed: torch.Tensor) -> torch.Tensor:
        """The lite ARAP energy between two timed point sets over the live
        rows, each neighbour weighted by its own liveness: the JAX package's
        sum over the whole capacity with the mask alive_i * alive_j, whose
        dead rows add exact zeros.  (Over the capacity, the backward's
        scatter into the rows the dead entries share serialises.)"""
        rows = torch.nonzero(gs.alive).squeeze(1)
        nbrs = self._arap_nbrs[rows]
        return arap_energy_knn(rest, deformed, nbrs, gs.alive.float()[nbrs], rows=rows)

    # -- losses -------------------------------------------------------------------
    def _motion_regularizers(self, gs, ep, batch, sched, generator, logs, draws) -> torch.Tensor:
        loss = torch.zeros((), device=self.device)
        timestamps, frame_indices = batch.get("timestamp"), batch.get("frame_indices")
        if timestamps is None or not (self.has_loss("lambda_ref_gs")
                                      or self.has_loss("lambda_lite_arap_reg")):
            return loss
        alive_f = gs.alive.float()
        n_alive = torch.clamp_min(torch.sum(alive_f), 1.0)
        deformation = ep.get("deformation")
        knots = self.geometry.control_knots(gs, deformation)
        f0 = frame_indices[0] if frame_indices is not None else 0
        xyz_t = self.geometry.get_timed_all(gs, timestamps[0], f0, deformation, knots)[0]

        if self.has_loss("lambda_ref_gs"):
            anchor = torch.sum(torch.sum((xyz_t - gs.params.xyz) ** 2, dim=-1) * alive_f) / n_alive
            logs["train/loss_ref_gs"] = anchor
            loss = loss + anchor * self.loss_lambda(sched, "lambda_ref_gs")

        if self.has_loss("lambda_lite_arap_reg") and self._arap_nbrs is not None:
            t_rand = uniforms(draws, "arap_t", 1, generator, self.device)[0]
            xyz_r = self.geometry.get_timed_all(gs, t_rand, f0, deformation, knots)[0]
            e = self._lite_arap(gs, xyz_t.detach(), xyz_r) / n_alive
            logs["train/loss_lite_arap_reg"] = e
            loss = loss + e * self.loss_lambda(sched, "lambda_lite_arap_reg")
        return loss

    def _inter_frame_losses(self, gs, ep, batch, sched, generator, logs, draws) -> torch.Tensor:
        loss = torch.zeros((), device=self.device)
        n_if, length = int(self.cfg.num_inter_frames), float(self.cfg.length_inter_frames)
        start = uniforms(draws, "inter_frame_start", 1, generator, self.device)[0] * (1.0 - length)
        ts = start + torch.linspace(0.0, length, n_if, device=self.device)
        deformation = ep.get("deformation")
        knots = self.geometry.control_knots(gs, deformation)
        f0 = batch["frame_indices"][0] if "frame_indices" in batch else 0

        if self.has_loss("lambda_lite_arap_reg") and self._arap_nbrs is not None:
            n_alive = torch.clamp_min(torch.sum(gs.alive.float()), 1.0)
            xyz_0 = self.geometry.get_timed_all(gs, ts[0], f0, deformation, knots)[0].detach()
            energies = [
                self._lite_arap(gs, xyz_0, self.geometry.get_timed_all(gs, t, f0, deformation,
                                                                       knots)[0]) / n_alive
                for t in ts[1:]
            ]
            e = torch.mean(torch.stack(energies))
            logs["train/loss_interf_lite_arap"] = e
            loss = loss + e * self.loss_lambda(sched, "lambda_lite_arap_reg")

        if self.guidance_2d is not None and self.has_loss("lambda_sds_2d"):
            batch_if = {
                "c2w": np.tile(np.asarray(batch["c2w"])[:1], (n_if, 1, 1)),
                "fovy": np.tile(np.asarray(batch["fovy"])[:1], (n_if,)),
                "timestamp": ts,
                "height": batch["height"],
                "width": batch["width"],
            }
            for key in ("elevation", "azimuth", "camera_distances"):
                if key in batch:
                    batch_if[key] = np.tile(np.asarray(batch[key])[:1], (n_if,))
            out_if = self.render_batch(gs, ep, batch_if, generator, sched, True)
            g2 = self.guidance_2d(out_if["comp_rgb"], self.prompt_utils_2d, batch_if,
                                  generator=generator, sched=sched.get("guidance"))
            logs["train/loss_interf_sds_2d"] = g2["loss_sds"]
            loss = loss + g2["loss_sds"] * self.loss_lambda(sched, "lambda_sds_2d")
        return loss

    def extra_substep_losses(self, gs, batch, sched, generator, logs, out_ref,
                             draws=None) -> torch.Tensor:
        if self.cfg.stage == "static":
            return self._gaussian_stage_losses(gs, batch, sched, generator, logs, out_ref, draws)
        return torch.zeros((), device=self.device)

    def _extra_sig(self, step: int) -> tuple:
        """(whether the inter-frame substep runs at this step,)"""
        freq = self.cfg.freq or {}
        every = int(freq.get("inter_frame_reg", 0))
        return (self.cfg.stage == "motion" and every > 0 and step % every == 0
                and step >= int(freq.get("milestone_inter_frame_reg", 0)),)

    # -- forward --------------------------------------------------------------------
    def forward_loss(self, gs, extra_params, batch, step, sched, generator):
        """The zero123 substep, the ref substep, then the motion stage's
        inter-frame substep and regularisers, in one backward; the
        densification statistics come from the last of the first two that
        ran."""
        draws = self.step_draws(step) if self.step_draws is not None else {}
        do_ref, do_z = self._substep_mode(step)
        rcb = batch.get("random_camera")
        if rcb is None:
            do_z = False
        b_stats = int(np.asarray(batch["c2w"]).shape[0] if do_ref
                      else np.asarray(rcb["c2w"]).shape[0])
        vs_dummy = torch.zeros((b_stats, gs.capacity, 2), device=self.device, requires_grad=True)

        logs: Dict[str, Any] = {}
        total = torch.zeros((), device=self.device)
        outs = []
        if do_z:
            out_z = self.render_batch(gs, extra_params, rcb, generator, sched, True,
                                      vs_dummy=None if do_ref else vs_dummy)
            guidance_out = self.guidance(out_z["comp_rgb"], self.prompt_utils, rcb,
                                         generator=generator, sched=sched.get("guidance"))
            logs["train/loss_zero123_sds"] = guidance_out["loss_sds"]
            logs["zero123/grad_norm"] = guidance_out["grad_norm"]
            lambdas = sched["lambdas"]
            lam = lambdas.get("lambda_sds_zero123", lambdas.get("lambda_sds", 0.0))
            total = total + guidance_out["loss_sds"] * lam
            outs.append(out_z)
        if do_ref:
            out_ref = self.render_batch(gs, extra_params, batch, generator, sched, True,
                                        vs_dummy=vs_dummy)
            loss_ref = self._ref_losses(out_ref, batch, sched, logs)
            mask = self._tensor(batch["mask"])
            logs["train/psnr"] = psnr(out_ref["comp_rgb"] * mask, self._tensor(batch["rgb"]) * mask)
            loss_ref = loss_ref + self.extra_substep_losses(gs, batch, sched, generator, logs,
                                                            out_ref, draws)
            total = total + loss_ref
            outs.append(out_ref)
        if self.cfg.stage == "motion":
            with span("system/motion_reg"):
                if self._extra_sig(step)[0]:
                    total = total + self._inter_frame_losses(gs, extra_params, batch, sched,
                                                             generator, logs, draws)
                total = total + self._motion_regularizers(gs, extra_params, batch, sched,
                                                          generator, logs, draws)
        logs["train/loss_total"] = total
        logs["gauss_num"] = gs.n_alive
        return total, logs, outs, vs_dummy

    def train_step(self, state: SystemState, batch, step: int, generator: torch.Generator):
        if self.cfg.stage == "motion" and self.has_loss("lambda_lite_arap_reg"):
            self._refresh_arap(state, step)
        if self.cfg.stage == "static" and (self.has_loss("lambda_density_regulation")
                                           or self.has_loss("lambda_normal_regulation")):
            self._refresh_knn(state, step)
        return super().train_step(state, batch, step, generator)
