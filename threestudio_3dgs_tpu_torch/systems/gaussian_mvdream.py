"""Multi-view (MVDream / ImageDream) system (port of the JAX package's
``systems/gaussian_mvdream.py``): the text-to-3D loss set, whose sparsity
term reads comp_mask, plus the predicted-normal MSE of the field's
``pred_normal`` channel (``comp_pred_normal``, blended by the renderer as
three extra channels) against the rendered depth normal."""

from __future__ import annotations

import torch

from ..utils.registry import register
from .gaussian_splatting import GaussianSplattingSystem


@register("gaussian-splatting-mvdream-system")
class MVDreamSystem(GaussianSplattingSystem):
    """The text-to-3D system under the multi-view YAMLs' name."""

    def compute_loss(self, out, gauss, batch, sched, generator):
        loss, logs = super().compute_loss(out, gauss, batch, sched, generator)
        if (self.has_loss("lambda_pred_normal") and "comp_pred_normal" in out
                and "comp_normal" in out):
            loss_pred_normal = torch.mean((out["comp_pred_normal"] - out["comp_normal"]) ** 2)
            logs["train/loss_pred_normal"] = loss_pred_normal
            loss = loss + loss_pred_normal * self.loss_lambda(sched, "lambda_pred_normal")
        logs["train/loss_total"] = loss
        return loss, logs
