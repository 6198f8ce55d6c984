"""SuGaR's 4D system: the motion stage of the dynamic mesh-bound Gaussians
(port of the JAX package's ``systems/sugar_4dgen.py``,
``sugar-4dgen-system``).

Per step, in one backward:
  * "zero123": the temporal Zero123 SDS on ``batch["random_camera"]``, each
    view rendered at its frame's time (``lambda_sds_zero123``, else
    ``lambda_sds``);
  * "ref": the fixed camera over the sampled frames, the image-to-3D ref
    losses (+ the PSNR log);
  * on the last of the two renders: the rgb / depth / normal TV and the
    normal vs depth-normal consistency;
  * on the mesh at the batch's first time: normal consistency, Laplacian
    smoothing and the object-centric term; ARAP (cotangent weights on the
    canonical mesh) between the canonical mesh and the mesh at a uniform
    random time, weighted by the largest of ``lambda_arap_reg`` (else
    ``lambda_full_arap_reg``), ``lambda_arap_reg_key_frame`` and
    ``lambda_arap_reg_inter_frame``; the t = 0 anchor ``lambda_ref_xyz``;
  * where ``freq.inter_frame_reg`` is due (from
    ``freq.milestone_inter_frame_reg``): ARAP at ``num_inter_frames`` times
    in a random window of ``length_inter_frames``, and the optional 2D SDS
    on renders of those times from the first reference camera.
The geometry's params take Adam with the geometry's ``lr_tree``; in mode
"deformation" the HexPlane network's parameters are
``extra_params["deformation"]``, trained by the extra Adam (``extra_lr``,
eps 1e-8).  ``attach_video_frames`` hands the frames to the guidance's
``prepare_embeddings``.

Random draws (the ARAP time, the window's start, the renders' and the
guidances' draws) come from the step's generator in the JAX package's
order; the test-only ``step_draws`` (step -> {"arap_t": ...,
"inter_frame_start": ...}) feeds the JAX package's draws in."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.deformation import DeformationConfig, init_deformation_params
from ..models.optim import init_adam
from ..ops import mesh as mesh_ops
from ..ops.arap import arap_energy, cotangent_weights
from ..utils.draws import uniforms
from ..utils.loss import psnr
from ..utils.registry import find, register
from .base import SystemState, flatten_extra
from .gaussian_zero123 import Zero123System
from .sugar_static import SugarStaticConfig, build_guidance_2d

ARAP_LAMBDAS = ("lambda_arap_reg", "lambda_full_arap_reg", "lambda_arap_reg_key_frame",
                "lambda_arap_reg_inter_frame")


@dataclasses.dataclass
class Sugar4DGenConfig(SugarStaticConfig):
    stage: str = "motion"
    num_inter_frames: int = 10
    length_inter_frames: float = 0.2
    guidance_zero123_type: Optional[str] = None
    guidance_zero123: dict = dataclasses.field(default_factory=dict)
    prompt_processor_3d_type: Optional[str] = None
    guidance_3d_type: Optional[str] = None


@register("sugar-4dgen-system")
class Sugar4DGenSystem(Zero123System):
    Config = Sugar4DGenConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        super().__init__(cfg, device, **kwargs)
        cfg = self.cfg
        if cfg.guidance_zero123_type:
            self.guidance = find(cfg.guidance_zero123_type)(cfg.guidance_zero123,
                                                            device=self.device)
        self.guidance_2d, self.prompt_utils_2d = build_guidance_2d(cfg, self.device)
        self.step_draws: Optional[Callable[[int], Dict[str, Any]]] = None
        self._arap_weights: Optional[torch.Tensor] = None
        self._refresh_arap_weights()  # the geometry may bind its mesh from the config

    def attach_video_frames(self, frames: np.ndarray) -> None:
        if hasattr(self.guidance, "prepare_embeddings"):
            self.guidance.prepare_embeddings(frames)

    def bind_mesh(self, verts, faces, colors=None) -> None:
        self.geometry.bind_mesh(verts, faces, colors)
        self._refresh_arap_weights()

    def _refresh_arap_weights(self) -> None:
        """The cotangent edge weights of the canonical (bound) mesh."""
        topo, bound = self.geometry.topology_t, self.geometry._bound_mesh
        if topo is None or bound is None:
            return
        self._arap_weights = cotangent_weights(
            torch.as_tensor(bound[0], device=self.device),
            torch.as_tensor(bound[1], device=self.device), topo.vert_nbr_idx,
            topo.vert_nbr_mask)

    def init_state(self, seed: int = 0) -> SystemState:
        """The geometry's state and, in mode "deformation", the deformation
        network's parameters (drawn from a generator seeded with
        ``seed + 1``) in the extra parameters with zeroed Adam moments."""
        state = super().init_state(seed)
        if self.geometry.cfg.dynamic_mode != "deformation":
            return state
        extra = dict(state.extra_params)
        extra["deformation"] = init_deformation_params(
            DeformationConfig(), torch.Generator(device=self.device).manual_seed(seed + 1),
            self.device)
        return SystemState(gauss=state.gauss, extra_params=extra,
                           extra_opt=init_adam(flatten_extra(extra)))

    # -- regularisers ----------------------------------------------------------------
    def _image_reg_losses(self, out, sched, logs) -> torch.Tensor:
        loss = self.tv_trio_losses(out, sched, logs)
        if (self.has_loss("lambda_normal_depth_consistency") and "comp_normal" in out
                and "comp_normal_from_dist" in out):
            v = torch.mean(((out["comp_normal"] * 2.0 - 1.0)
                            - (out["comp_normal_from_dist"] * 2.0 - 1.0)) ** 2)
            logs["train/loss_normal_depth_consistency"] = v
            loss = loss + v * self.loss_lambda(sched, "lambda_normal_depth_consistency")
        return loss

    def _arap(self, gs, verts_def: torch.Tensor) -> torch.Tensor:
        """ARAP between the canonical and a timed mesh, per vertex."""
        topo = self.geometry.topology_t
        points = gs.params.points
        return arap_energy(points, verts_def, topo.vert_nbr_idx, topo.vert_nbr_mask,
                           weights=self._arap_weights) / points.shape[0]

    def _mesh_motion_losses(self, gs, ep, batch, sched, generator, logs, draws) -> torch.Tensor:
        loss = torch.zeros((), device=self.device)
        geo, topo = self.geometry, self.geometry.topology_t
        deformation = ep.get("deformation")
        t0 = batch["timestamp"][0] if "timestamp" in batch else 0.0
        f0 = batch["frame_indices"][0] if "frame_indices" in batch else 0
        verts_t = geo.timed_vertices(gs, t0, f0, deformation)

        if self.has_loss("lambda_normal_consistency"):
            nc = mesh_ops.normal_consistency_loss(verts_t, gs.faces, topo.edge_faces)
            logs["train/loss_normal_consistency"] = nc
            loss = loss + nc * self.loss_lambda(sched, "lambda_normal_consistency")
        if self.has_loss("lambda_laplacian_smoothing"):
            lap = mesh_ops.laplacian_smoothing_loss(verts_t, topo.vert_nbr_idx, topo.vert_nbr_mask)
            logs["train/loss_laplacian_smoothing"] = lap
            loss = loss + lap * self.loss_lambda(sched, "lambda_laplacian_smoothing")
        if any(self.has_loss(name) for name in ARAP_LAMBDAS):
            # one random-time ARAP stands for the reference's key-frame and
            # inter-frame terms: its weight is the largest of the aliases
            t_rand = uniforms(draws, "arap_t", 1, generator, self.device)[0]
            e = self._arap(gs, geo.timed_vertices(gs, t_rand, f0, deformation))
            logs["train/loss_arap_reg"] = e
            lambdas = sched["lambdas"]
            lam = max(lambdas.get("lambda_arap_reg", lambdas.get("lambda_full_arap_reg", 0.0)),
                      lambdas.get("lambda_arap_reg_key_frame", 0.0),
                      lambdas.get("lambda_arap_reg_inter_frame", 0.0))
            loss = loss + e * lam
        if self.has_loss("lambda_ref_xyz"):
            verts_0 = geo.timed_vertices(gs, 0.0, 0, deformation)
            anchor = torch.mean(torch.abs(verts_0 - gs.params.points))
            logs["train/loss_ref_xyz"] = anchor
            loss = loss + anchor * self.loss_lambda(sched, "lambda_ref_xyz")
        if self.has_loss("lambda_obj_centric"):
            oc = torch.abs(torch.mean(verts_t[..., 0])) + torch.abs(torch.mean(verts_t[..., 1]))
            logs["train/loss_obj_centric"] = oc
            loss = loss + oc * self.loss_lambda(sched, "lambda_obj_centric")
        return loss

    def _inter_frame_losses(self, gs, ep, batch, sched, generator, logs, draws, outs
                            ) -> torch.Tensor:
        """ARAP at ``num_inter_frames`` times in a random window, and the 2D
        SDS on the first reference camera's renders at those times (their
        render output appended to ``outs``)."""
        loss = torch.zeros((), device=self.device)
        n_if, length = int(self.cfg.num_inter_frames), float(self.cfg.length_inter_frames)
        start = uniforms(draws, "inter_frame_start", 1, generator, self.device)[0] * (1.0 - length)
        ts = start + torch.linspace(0.0, length, n_if, device=self.device)
        deformation = ep.get("deformation")
        f0 = batch["frame_indices"][0] if "frame_indices" in batch else 0

        if self.has_loss("lambda_arap_reg_inter_frame") or self.has_loss("lambda_arap_reg"):
            e = torch.mean(torch.stack([
                self._arap(gs, self.geometry.timed_vertices(gs, t, f0, deformation)) for t in ts]))
            logs["train/loss_arap_reg_inter_frame"] = e
            lambdas = sched["lambdas"]
            loss = loss + e * lambdas.get("lambda_arap_reg_inter_frame",
                                          lambdas.get("lambda_arap_reg", 0.0))

        if self.guidance_2d is not None and self.has_loss("lambda_sds_2d"):
            def first(key, default):
                return np.tile(np.asarray(batch[key])[:1], (n_if,)) if key in batch else \
                    np.full((n_if,), default, np.float32)

            batch_if = {
                "c2w": np.tile(np.asarray(batch["c2w"])[:1], (n_if, 1, 1)),
                "fovy": np.tile(np.asarray(batch["fovy"])[:1], (n_if,)),
                "elevation": first("elevation", 0.0),
                "azimuth": first("azimuth", 0.0),
                "camera_distances": first("camera_distances", 1.0),
                "timestamp": ts, "height": batch["height"], "width": batch["width"],
            }
            out_if = self.render_batch(gs, ep, batch_if, generator, sched, True)
            g2 = self.guidance_2d(out_if["comp_rgb"], self.prompt_utils_2d, batch_if,
                                  generator=generator, sched=sched.get("guidance"))
            logs["train/loss_interf_sds_2d"] = g2["loss_sds"]
            loss = loss + g2["loss_sds"] * self.loss_lambda(sched, "lambda_sds_2d")
            outs.append(out_if)
        return loss

    def _extra_sig(self, step: int) -> tuple:
        """(whether the inter-frame substep runs at this step,)"""
        freq = self.cfg.freq or {}
        every = int(freq.get("inter_frame_reg", 0))
        return (every > 0 and step % every == 0
                and step >= int(freq.get("milestone_inter_frame_reg", 0)),)

    # -- the step --------------------------------------------------------------------
    def forward_loss(self, gs, extra_params, batch, step, sched, generator):
        """The zero123 and ref substeps, the image regularisers on the last
        of their renders, the mesh-motion regularisers and, where due, the
        inter-frame substep.  The mesh-bound Gaussians keep no densify
        statistics, so ``vs_dummy`` is an empty zeros tensor."""
        draws = self.step_draws(step) if self.step_draws is not None else {}
        do_ref, do_z = self._substep_mode(step)
        rcb = batch.get("random_camera")
        logs: Dict[str, Any] = {}
        total = torch.zeros((), device=self.device)
        outs = []
        if do_z and rcb is not None:
            out_z = self.render_batch(gs, extra_params, rcb, generator, sched, True)
            guidance_out = self.guidance(out_z["comp_rgb"], self.prompt_utils, rcb,
                                         generator=generator, sched=sched.get("guidance"))
            logs["train/loss_zero123_sds"] = guidance_out["loss_sds"]
            if "grad_norm" in guidance_out:
                logs["zero123/grad_norm"] = guidance_out["grad_norm"]
            lambdas = sched["lambdas"]
            total = total + guidance_out["loss_sds"] * lambdas.get(
                "lambda_sds_zero123", lambdas.get("lambda_sds", 0.0))
            outs.append(out_z)
        if do_ref:
            out_ref = self.render_batch(gs, extra_params, batch, generator, sched, True)
            total = total + self._ref_losses(out_ref, batch, sched, logs)
            mask = self._tensor(batch["mask"])
            logs["train/psnr"] = psnr(out_ref["comp_rgb"] * mask, self._tensor(batch["rgb"]) * mask)
            outs.append(out_ref)
        if outs:
            total = total + self._image_reg_losses(outs[-1], sched, logs)
        total = total + self._mesh_motion_losses(gs, extra_params, batch, sched, generator, logs,
                                                 draws)
        if self._extra_sig(step)[0]:
            total = total + self._inter_frame_losses(gs, extra_params, batch, sched, generator,
                                                     logs, draws, outs)
        logs["train/loss_total"] = total
        return total, logs, outs, torch.zeros((0, 2), device=self.device, requires_grad=True)
