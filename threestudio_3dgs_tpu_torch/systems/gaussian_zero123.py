"""Image-to-3D system (port of the JAX package's
``systems/gaussian_zero123.py``, ``gaussian-splatting-zero123-system``).

Two substeps per iteration, one backward through both:
  * "zero123": the Zero123 SDS on ``batch["random_camera"]``, rendered
    with an ambient ratio drawn uniformly in [ambient_ratio_min, 1];
  * "ref": the fixed reference camera at ambient ratio 1 with diffuse
    shading, supervised by the reference image: rgb and mask MSE, the
    least-squares-aligned depth, 1 - the masked Pearson correlation of the
    depth, and the normal cosine, each where its lambda can be > 0 and the
    batch carries its map.
``freq.ref_or_zero123`` picks "accumulate" (both substeps every step) or
alternate scheduling.  The densification statistics come from the last
substep that ran (the ref view's shape when it runs).  The hooks
``_extra_sig``, ``_guidance_2d_losses`` and ``extra_substep_losses`` are
no-ops here, for the 4D and SuGaR systems that subclass this one.

The guidance is never given the reference frame (``prepare_embeddings``),
as in the JAX package, so the YAML's Zero123 guidance runs its analytic
prior."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..utils.draws import uniforms
from ..utils.registry import register
from .base import BaseGaussianSystem, BaseSystemConfig


@dataclasses.dataclass
class Zero123SystemConfig(BaseSystemConfig):
    refinement: bool = False
    ambient_ratio_min: float = 0.5
    back_ground_color: Tuple[float, float, float] = (1, 1, 1)


def masked_depth_align_loss(pred: torch.Tensor, gt: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked pixels between the predicted depth and the best
    affine map a gt + b of the reference depth (the 2x2 normal equations in
    closed form; a and b carry no gradient)."""
    m, p, g = mask.reshape(-1), pred.reshape(-1), gt.reshape(-1)
    n = torch.clamp_min(torch.sum(m), 1.0)
    sg, sp = torch.sum(m * g), torch.sum(m * p)
    sgg, sgp = torch.sum(m * g * g), torch.sum(m * g * p)
    det = n * sgg - sg * sg
    a = torch.where(torch.abs(det) > 1e-8, (n * sgp - sg * sp) / det, torch.zeros_like(det))
    b = (sp - a * sg) / n
    aligned = a.detach() * g + b.detach()
    return torch.sum(m * (aligned - p) ** 2) / n


def masked_pearson(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The Pearson correlation of pred and gt over the masked pixels."""
    m, p, g = mask.reshape(-1), pred.reshape(-1), gt.reshape(-1)
    n = torch.clamp_min(torch.sum(m), 1.0)
    pc = (p - torch.sum(m * p) / n) * m
    gc = (g - torch.sum(m * g) / n) * m
    return torch.sum(pc * gc) / torch.clamp_min(torch.linalg.norm(pc) * torch.linalg.norm(gc), eps)


@register("gaussian-splatting-zero123-system")
class Zero123System(BaseGaussianSystem):
    Config = Zero123SystemConfig
    # the JAX package's zero123 step (and so its 4D and SuGaR steps) never
    # runs the pair-capacity controller: the renderer keeps max_pairs
    adapts_pair_capacity = False
    # its train_step is its own in the JAX package, which ignores the mesh
    shards_camera_batch = False

    def _substep_mode(self, step: int) -> Tuple[bool, bool]:
        mode = self.cfg.freq.get("ref_or_zero123", "accumulate")
        if mode == "accumulate":
            return True, True
        do_ref = (step < self.cfg.freq.get("ref_only_steps", 0)
                  or step % int(self.cfg.freq.get("n_ref", 1)) == 0)
        return do_ref, not do_ref

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=torch.float32, device=self.device)

    # -- losses ---------------------------------------------------------------
    def _ref_losses(self, out, batch, sched, logs) -> torch.Tensor:
        gt_mask = self._tensor(batch["mask"])
        gt_rgb = self._tensor(batch["rgb"]) * gt_mask
        loss_rgb = torch.mean((gt_rgb - out["comp_rgb"] * gt_mask) ** 2)
        logs["train/loss_ref_rgb"] = loss_rgb
        loss = loss_rgb * self.loss_lambda(sched, "lambda_rgb")

        loss_mask = torch.mean((gt_mask - out["comp_mask"]) ** 2)
        logs["train/loss_ref_mask"] = loss_mask
        loss = loss + loss_mask * self.loss_lambda(sched, "lambda_mask")

        ref_depth = batch.get("ref_depth")
        if self.has_loss("lambda_depth") and ref_depth is not None:
            ld = masked_depth_align_loss(out["comp_depth"], self._tensor(ref_depth), gt_mask)
            logs["train/loss_ref_depth"] = ld
            loss = loss + ld * self.loss_lambda(sched, "lambda_depth")

        if self.has_loss("lambda_depth_rel") and ref_depth is not None:
            lrel = 1.0 - masked_pearson(out["comp_depth"], self._tensor(ref_depth), gt_mask)
            logs["train/loss_ref_depth_rel"] = lrel
            loss = loss + lrel * self.loss_lambda(sched, "lambda_depth_rel")

        ref_normal = batch.get("ref_normal")
        if self.has_loss("lambda_normal") and ref_normal is not None and "comp_normal" in out:
            gt_n = 1.0 - 2.0 * self._tensor(ref_normal)
            pred_n = 2.0 * out["comp_normal"] - 1.0
            cos = torch.sum(gt_n * pred_n, dim=-1) / torch.clamp_min(
                torch.linalg.norm(gt_n, dim=-1) * torch.linalg.norm(pred_n, dim=-1), 1e-6)
            m = gt_mask[..., 0]
            ln = 1.0 - torch.sum(cos * m) / torch.clamp_min(torch.sum(m), 1.0)
            logs["train/loss_ref_normal"] = ln
            loss = loss + ln * self.loss_lambda(sched, "lambda_normal")
        return loss

    def _normal_smooth_loss(self, out, sched, logs, prefix) -> torch.Tensor:
        if self.has_loss("lambda_normal_smooth") and "comp_normal" in out:
            n = out["comp_normal"]
            ls = (torch.mean((n[:, 1:] - n[:, :-1]) ** 2)
                  + torch.mean((n[:, :, 1:] - n[:, :, :-1]) ** 2))
            logs[f"train/loss_{prefix}_normal_smooth"] = ls
            return ls * self.loss_lambda(sched, "lambda_normal_smooth")
        return torch.zeros((), device=self.device)

    def _extra_sig(self, step: int) -> tuple:
        """Step-dependent flags a subclass's losses key on (the JAX
        package's extra jit-signature entries); none here."""
        return ()

    def _guidance_2d_losses(self, out_z, rcb, sched, generator, logs, sig) -> torch.Tensor:
        """A subclass's 2D-diffusion SDS on the random-camera substep; none
        here."""
        return torch.zeros((), device=self.device)

    def extra_substep_losses(self, gs, batch, sched, generator, logs, out_ref) -> torch.Tensor:
        """A subclass's regularisers on the ref substep; none here."""
        return torch.zeros((), device=self.device)

    # -- forward ----------------------------------------------------------------
    def render_batch(self, gauss, extra_params, batch, generator, sched, training,
                     vs_dummy=None, ambient_ratio=None, shading=None):
        return self.renderer.batch_forward(
            gauss, batch,
            bg_params=extra_params.get("background") if extra_params else None,
            generator=generator, training=training,
            ambient_only=bool(sched.get("ambient_only", False)) if sched else False,
            color_clip=sched["color_clip"] if sched else 1e9,
            means2d_offset=vs_dummy, ambient_ratio=ambient_ratio, shading=shading,
            deformation_params=extra_params.get("deformation") if extra_params else None,
        )

    # -- train step ---------------------------------------------------------------
    def forward_loss(self, gs, extra_params, batch, step, sched, generator):
        """Both substeps in one backward: the zero123 SDS on the random
        cameras, then the ref view; the densify statistics come from the
        last substep that ran."""
        do_ref, do_z = self._substep_mode(step)
        rcb = batch.get("random_camera")
        if rcb is None:
            do_z = False
        sig = self._extra_sig(step)
        b_stats = int(np.asarray(batch["c2w"]).shape[0] if do_ref
                      else np.asarray(rcb["c2w"]).shape[0])
        vs_dummy = torch.zeros((b_stats, gs.capacity, 2), device=self.device,
                               requires_grad=True)

        logs: Dict[str, Any] = {}
        total = torch.zeros((), device=self.device)
        outs = []  # the substeps' render outputs, in order
        if do_z:
            u = uniforms(None, "ambient_ratio", 1, generator, self.device)
            ambient_ratio = self.cfg.ambient_ratio_min + (1.0 - self.cfg.ambient_ratio_min) * u[0]
            out_z = self.render_batch(gs, extra_params, rcb, generator, sched, True,
                                      vs_dummy=None if do_ref else vs_dummy,
                                      ambient_ratio=ambient_ratio)
            guidance_out = self.guidance(out_z["comp_rgb"], self.prompt_utils, rcb,
                                         generator=generator, sched=sched.get("guidance"))
            logs["train/loss_zero123_sds"] = guidance_out["loss_sds"]
            if "grad_norm" in guidance_out:  # fake-mse-guidance has none
                logs["zero123/grad_norm"] = guidance_out["grad_norm"]
            loss_z = guidance_out["loss_sds"] * self.loss_lambda(sched, "lambda_sds")
            loss_z = loss_z + self._normal_smooth_loss(out_z, sched, logs, "zero123")
            loss_z = loss_z + self._guidance_2d_losses(out_z, rcb, sched, generator, logs, sig)
            total = total + loss_z
            outs.append(out_z)
        if do_ref:
            out_ref = self.render_batch(gs, extra_params, batch, generator, sched, True,
                                        vs_dummy=vs_dummy, ambient_ratio=1.0, shading="diffuse")
            loss_ref = self._ref_losses(out_ref, batch, sched, logs)
            loss_ref = loss_ref + self._normal_smooth_loss(out_ref, sched, logs, "ref")
            loss_ref = loss_ref + self.extra_substep_losses(gs, batch, sched, generator, logs,
                                                            out_ref)
            total = total + loss_ref
            outs.append(out_ref)
        logs["train/loss_total"] = total
        logs["gauss_num"] = gs.n_alive
        return total, logs, outs, vs_dummy
