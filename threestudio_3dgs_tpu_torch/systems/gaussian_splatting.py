"""Text-to-3D SDS system (port of the JAX package's
``systems/gaussian_splatting.py``): every guidance output named loss_*
weighted by lambda_*, plus the position / opacity / scales / TV / depth-TV
regularisers."""

from __future__ import annotations

import torch

from ..models import gaussian_field as gf
from ..utils.loss import tv_loss
from ..utils.registry import register
from .base import BaseGaussianSystem, BaseSystemConfig


@register("gaussian-splatting-system")
class GaussianSplattingSystem(BaseGaussianSystem):
    Config = BaseSystemConfig

    def compute_loss(self, out, gauss, batch, sched, generator):
        logs = {}
        guidance_out = self.guidance(
            out["comp_rgb"], self.prompt_utils, batch,
            generator=generator, sched=sched.get("guidance"),
        )
        loss = torch.zeros((), device=out["comp_rgb"].device)
        for name, value in guidance_out.items():
            logs[f"train/{name}"] = value
            if name.startswith("loss_"):
                loss = loss + value * self.loss_lambda(sched, name.replace("loss_", "lambda_"))

        params = gauss.params
        alive = gauss.alive.float()
        n_alive = torch.clamp_min(torch.sum(alive), 1.0)

        if self.has_loss("lambda_position"):
            xyz_norm = torch.linalg.norm(params.xyz, dim=-1) * alive
            loss_position = torch.sum(xyz_norm) / n_alive
            logs["train/loss_position"] = loss_position
            loss = loss + self.loss_lambda(sched, "lambda_position") * loss_position

        if self.has_loss("lambda_opacity"):
            scaling = torch.linalg.norm(gf.get_scaling(params), dim=-1)
            opac = gf.get_opacity(params)[:, 0]
            loss_opacity = torch.sum(scaling.detach() * opac * alive)
            logs["train/loss_opacity"] = loss_opacity
            loss = loss + self.loss_lambda(sched, "lambda_opacity") * loss_opacity

        if self.has_loss("lambda_scales"):
            scale_sum = torch.sum(gf.get_scaling(params) * alive[:, None])
            logs["train/scales"] = scale_sum
            loss = loss + self.loss_lambda(sched, "lambda_scales") * scale_sum

        if self.has_loss("lambda_tv_loss"):
            loss_tv = tv_loss(out["comp_rgb"])
            logs["train/loss_tv"] = loss_tv
            loss = loss + self.loss_lambda(sched, "lambda_tv_loss") * loss_tv

        if self.has_loss("lambda_depth_tv_loss") and "comp_depth" in out:
            terms = tv_loss(out["comp_depth"])
            if "comp_normal" in out:
                terms = terms + tv_loss(out["comp_normal"])
            logs["train/loss_depth_tv"] = terms
            loss = loss + self.loss_lambda(sched, "lambda_depth_tv_loss") * terms

        if self.has_loss("lambda_sparsity") and "comp_mask" in out:
            loss_sparsity = torch.mean(out["comp_mask"])
            logs["train/loss_sparsity"] = loss_sparsity
            loss = loss + self.loss_lambda(sched, "lambda_sparsity") * loss_sparsity

        logs["train/loss_total"] = loss
        logs["gauss_num"] = gauss.n_alive
        return loss, logs
