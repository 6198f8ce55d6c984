"""SuGaR's free-Gaussian surface regularisers (port of the mixin of the JAX
package's ``systems/sugar_static.py``; its ``sugar-static-system`` itself is
not ported yet).

``GaussianStageRegMixin`` gives a system, on its reference substep:
  * the opacity binary term mean(a (1 - a)) over the live Gaussians;
  * the rgb / depth / normal TV trio;
  * the density regulation against the rendered depth of the first
    reference view and the SDF better-normal alignment
    (``ops/sugar_reg.py``, at most 8192 and 2048 samples), on a k-NN table
    of the live Gaussians refreshed every ``reset_neighbors_every`` steps.
The 4D system's static stage uses it."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import gaussian_field as gf
from ..ops import knn as knn_ops
from ..ops import sugar_reg
from ..ops.camera import camera_from_c2w
from ..utils.config import parse_structured


@torch.no_grad()
def alive_knn(xyz: torch.Tensor, alive: torch.Tensor, k: int, exclude_self: bool) -> torch.Tensor:
    """(CAP, k) neighbour table of the live rows among the live rows.  The
    JAX package queries every row with the dead ones moved to 1e6, so a
    live row's neighbours are the same; where there are fewer than k live
    neighbours, and on dead rows, the table holds a dead row (masked or
    weighted out by every user) or, in a full field, the row itself."""
    cap = xyz.shape[0]
    rows = torch.nonzero(alive).squeeze(1)
    dead = torch.nonzero(~alive).squeeze(1)
    pad = dead[0] if dead.numel() else None
    table = (torch.arange(cap, device=xyz.device)[:, None].expand(cap, k).clone()
             if pad is None else torch.full((cap, k), int(pad), device=xyz.device))
    n = rows.numel()
    kk = min(k, n - 1 if exclude_self else n)
    if kk > 0:
        pts = xyz[rows]
        _, idx = knn_ops.knn(pts, pts, k=kk, exclude_self=exclude_self)
        table[rows, :kk] = rows[idx]
    return table


class GaussianStageRegMixin:
    def _init_sugar_stage(self, sugar_dict) -> None:
        self.sugar_cfg = parse_structured(sugar_reg.SuGaRRegConfig, dict(sugar_dict))
        self._knn_idx: Optional[torch.Tensor] = None
        self._knn_step = -(10 ** 9)

    def _refresh_knn(self, state, step: int) -> None:
        """The neighbour table (self match included, as the reference's
        knn_points gives it) every ``reset_neighbors_every`` steps."""
        if self._knn_idx is not None and step - self._knn_step < self.sugar_cfg.reset_neighbors_every:
            return
        gauss = state.gauss
        self._knn_idx = alive_knn(gauss.params.xyz.detach(), gauss.alive,
                                  self.sugar_cfg.knn_to_track, exclude_self=False)
        self._knn_step = step

    def _gaussian_stage_losses(self, gs, batch, sched, generator, logs, out_ref,
                               draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """``draws`` (tests only): {"density": ..., "normal": ...}, each the
        ``ops/sugar_reg.py`` draws of that loss."""
        draws = draws or {}
        loss = torch.zeros((), device=self.device)
        params = gs.params
        alive_f = gs.alive.float()
        opac = gf.get_opacity(params)[:, 0]

        if self.has_loss("lambda_opacity_binary"):
            binary = torch.sum(opac * (1.0 - opac) * alive_f) / torch.clamp_min(
                torch.sum(alive_f), 1.0)
            logs["train/loss_opacity_binary"] = binary
            loss = loss + binary * self.loss_lambda(sched, "lambda_opacity_binary")

        if out_ref is not None:
            loss = self.tv_trio_losses(out_ref, sched, logs, loss)

        needs_density = self.has_loss("lambda_density_regulation")
        needs_normal = self.has_loss("lambda_normal_regulation")
        if (needs_density or needs_normal) and self._knn_idx is not None:
            gaussians = dict(means=params.xyz, scales=gf.get_scaling(params),
                             quats=params.rotation, opacities=opac, alive=gs.alive)
            n_samples = min(self.sugar_cfg.n_samples_for_sdf_regularization, 8192)
            if needs_density and out_ref is not None and "comp_depth" in out_ref:
                depth = out_ref["comp_depth"]
                fovy = float(batch["fovy"][0])
                cam = camera_from_c2w(batch["c2w"][0], fovy, fovy, depth.shape[1], depth.shape[2],
                                      device=self.device)
                dens_loss, beta = sugar_reg.density_regulation_loss(
                    generator, gaussians, self._knn_idx, cam, depth[0, :, :, 0].detach(),
                    n_samples, draws.get("density"))
                logs["train/loss_density_regulation"] = dens_loss
                logs["train/sugar_beta"] = beta
                loss = loss + dens_loss * self.loss_lambda(sched, "lambda_density_regulation")
            if needs_normal:
                nl = sugar_reg.sdf_better_normal_loss(generator, gaussians, self._knn_idx,
                                                      min(n_samples, 2048),
                                                      draws=draws.get("normal"))
                logs["train/loss_normal_regulation"] = nl
                loss = loss + nl * self.loss_lambda(sched, "lambda_normal_regulation")
        return loss
