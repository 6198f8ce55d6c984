"""SuGaR's static two-stage system (port of the JAX package's
``systems/sugar_static.py``, ``sugar-static-system``), and the mixin of
SuGaR's free-Gaussian surface regularisers it shares with the 4D system.

``GaussianStageRegMixin`` gives a system, on its reference substep:
  * the opacity binary term mean(a (1 - a)) over the live Gaussians;
  * the rgb / depth / normal TV trio;
  * the density regulation against the rendered depth of the first
    reference view and the SDF better-normal alignment
    (``ops/sugar_reg.py``, at most 8192 and 2048 samples), on a k-NN table
    of the live Gaussians refreshed every ``reset_neighbors_every`` steps.

``SugarStaticSystem``:
  * stage "gaussian" (``gs_to_sugar*.yaml``): the image-to-3D step of
    ``Zero123System`` with the mixin's regularisers, the optional 2D SDS on
    the random-camera substep (``guidance_2d_type``), and the geometry's
    structural update, whose ``sugar_prune_at`` hard-prunes the
    low-opacity Gaussians for the handoff;
  * stage "sugar" (``sugar_static_refine*.yaml``): the ``sugar`` geometry
    bound to a mesh extracted from ``geometry_convert_from`` (a port
    ``.ckpt.npz`` or a 3DGS ``.ply`` of the gaussian stage) or read from an
    ``.obj``, rendered by the SuGaR renderers (K1/K2 at 7 channels), with
    the zero123 and ref substeps' losses plus normal consistency, Laplacian
    smoothing, opacity-max, normal-depth consistency and the TV terms; Adam
    over the mesh-bound params, the extra Adam over the background's.

Random draws come from the step's generator; the test-only ``step_draws``
(step -> {"density": ..., "normal": ...}) feeds the JAX package's SuGaR
samples in.  ``--predict`` bakes the sugar stage's textured mesh
(``models/texture_bake.py``: an OBJ with a UV atlas, its MTL and PNG),
after peeling the low-density border faces when ``postprocess`` is set."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import gaussian_field as gf
from ..models.sugar import gaussian_strengths
from ..ops import knn as knn_ops
from ..ops import mesh as mesh_ops
from ..ops import sugar_reg
from ..ops.camera import camera_from_c2w
from ..utils.config import parse_structured
from ..utils.loss import tv_loss
from ..utils.registry import find, register
from .base import SystemState
from .gaussian_zero123 import Zero123System, Zero123SystemConfig


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


def build_guidance_2d(cfg, device) -> Tuple[Any, Any]:
    """The optional 2D-diffusion guidance of ``guidance_2d_type`` and the
    prompts of ``prompt_processor_2d_type`` (None for either unset)."""
    guidance = (find(cfg.guidance_2d_type)(cfg.guidance_2d, device=device)
                if cfg.guidance_2d_type else None)
    pp2 = (find(cfg.prompt_processor_2d_type)(cfg.prompt_processor_2d, device=device)
           if cfg.prompt_processor_2d_type else None)
    return guidance, pp2() if pp2 else None


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


@dataclasses.dataclass
class SugarStaticConfig(Zero123SystemConfig):
    stage: str = "gaussian"  # "gaussian" | "sugar"
    sugar: dict = dataclasses.field(default_factory=dict)
    # the border faces' cleanup before the texture bake of --predict
    postprocess: bool = False
    postprocess_density_threshold: float = 0.1
    postprocess_iterations: int = 5
    # the optional 2D-diffusion SDS on the random-camera substep, on the
    # normals every freq.input_normal steps, from freq.milestone_2d_sds
    guidance_2d_type: Optional[str] = None
    guidance_2d: dict = dataclasses.field(default_factory=dict)
    prompt_processor_2d_type: Optional[str] = None
    prompt_processor_2d: dict = dataclasses.field(default_factory=dict)
    n_samples_for_sugar_sdf_reg: Optional[int] = None  # the reference's name


@register("sugar-static-system")
class SugarStaticSystem(GaussianStageRegMixin, Zero123System):
    Config = SugarStaticConfig

    # the reference's lambda names -> the port's (gs_to_sugar.yaml)
    _LOSS_ALIASES = {
        "lambda_sugar_density_reg": "lambda_density_regulation",
        "lambda_sugar_sdf_normal_reg": "lambda_normal_regulation",
    }

    def __init__(self, cfg=None, device="cuda", **kwargs):
        super().__init__(cfg, device, **kwargs)
        cfg = self.cfg
        for ref_name, ours in self._LOSS_ALIASES.items():
            if ref_name in cfg.loss and ours not in cfg.loss:
                cfg.loss[ours] = cfg.loss[ref_name]
        sugar_dict = dict(cfg.sugar)
        if cfg.n_samples_for_sugar_sdf_reg is not None:
            sugar_dict.setdefault("n_samples_for_sdf_regularization",
                                  cfg.n_samples_for_sugar_sdf_reg)
        self._init_sugar_stage(sugar_dict)
        self.guidance_2d, self.prompt_utils_2d = build_guidance_2d(cfg, self.device)
        self.step_draws: Optional[Callable[[int], Dict[str, Any]]] = None
        self._draws: Dict[str, Any] = {}
        if cfg.stage == "sugar":
            self._maybe_bind_mesh()

    # -- the optional 2D SDS -----------------------------------------------------
    def _extra_sig(self, step: int) -> tuple:
        """(use the 2D SDS, feed it the normals) at this step."""
        if self.guidance_2d is None:
            return (False, False)
        freq = self.cfg.freq or {}
        every = max(int(freq.get("input_normal", 0)), 0)
        return (step >= int(freq.get("milestone_2d_sds", 0)), every > 0 and step % every == 0)

    def _guidance_2d_losses(self, out_z, rcb, sched, generator, logs, sig) -> torch.Tensor:
        use_2d, use_normal = sig
        if self.guidance_2d is None or not use_2d:
            return torch.zeros((), device=self.device)
        inp = out_z["comp_normal"] if use_normal and "comp_normal" in out_z else out_z["comp_rgb"]
        g2 = self.guidance_2d(inp, self.prompt_utils_2d, rcb, generator=generator,
                              sched=sched.get("guidance"))
        logs["train/loss_sds_2d"] = g2["loss_sds"]
        return g2["loss_sds"] * self.loss_lambda(sched, "lambda_sds_2d")

    def extra_substep_losses(self, gs, batch, sched, generator, logs, out_ref) -> torch.Tensor:
        if self.cfg.stage == "gaussian":
            return self._gaussian_stage_losses(gs, batch, sched, generator, logs, out_ref,
                                               self._draws)
        return torch.zeros((), device=self.device)

    # -- the sugar stage's mesh --------------------------------------------------
    def _maybe_bind_mesh(self) -> None:
        """Binds the mesh of ``geometry_convert_from`` when the geometry has
        none: extracted from a gaussian-stage ``.ckpt.npz`` / ``.npz`` or
        3DGS ``.ply``, or read from an ``.obj``; any other source raises."""
        src = self.cfg.geometry_convert_from or self.cfg.geometry.get("geometry_convert_from", "")
        if not src or getattr(self.geometry, "_bound_mesh", None) is not None:
            return
        from ..models.mesh_extract import extract_mesh_from_gaussians

        if src.endswith(".npz"):
            from ..utils.ckpt import load_checkpoint

            g_state = load_checkpoint(src, self.device)[0].gauss
        elif src.endswith(".ply"):
            g_state = gf.init_state(gf.GaussianFieldConfig(geometry_convert_from=src),
                                    device=self.device)
        elif src.endswith(".obj"):
            self.geometry.bind_mesh(*mesh_ops.load_obj(src))
            return
        else:
            raise ValueError(f"the sugar stage binds a mesh from a .ckpt.npz, .ply or .obj, "
                             f"got {src!r}")
        verts, faces = extract_mesh_from_gaussians(g_state)
        if verts is None:
            raise ValueError(f"mesh extraction from {src!r} found no surface (Gaussians too "
                             "diffuse?); cannot bind the sugar stage")
        self.geometry.bind_mesh(verts, faces)

    def bind_mesh(self, verts, faces, colors=None) -> None:
        self.geometry.bind_mesh(verts, faces, colors)

    # -- the sugar stage's step ----------------------------------------------------
    def forward_loss(self, gs, extra_params, batch, step, sched, generator):
        """Stage "sugar": the zero123 substep (with the 2D SDS), the ref
        substep, then the mesh and image regularisers on the last substep's
        render.  The mesh-bound Gaussians keep no densify statistics, so its
        ``vs_dummy`` is an empty zeros tensor."""
        if self.cfg.stage != "sugar":
            return super().forward_loss(gs, extra_params, batch, step, sched, generator)
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
            total = total + guidance_out["loss_sds"] * self.loss_lambda(sched, "lambda_sds")
            total = total + self._guidance_2d_losses(out_z, rcb, sched, generator, logs,
                                                     self._extra_sig(step))
            outs.append(out_z)
        if do_ref:
            out_ref = self.render_batch(gs, extra_params, batch, generator, sched, True)
            total = total + self._ref_losses(out_ref, batch, sched, logs)
            outs.append(out_ref)
        out = outs[-1] if outs else None

        verts, topo = gs.params.points, self.geometry.topology_t
        if self.has_loss("lambda_normal_consistency"):
            nc = mesh_ops.normal_consistency_loss(verts, gs.faces, topo.edge_faces)
            logs["train/loss_normal_consistency"] = nc
            total = total + nc * self.loss_lambda(sched, "lambda_normal_consistency")
        if self.has_loss("lambda_laplacian_smoothing"):
            lap = mesh_ops.laplacian_smoothing_loss(verts, topo.vert_nbr_idx, topo.vert_nbr_mask)
            logs["train/loss_laplacian_smoothing"] = lap
            total = total + lap * self.loss_lambda(sched, "lambda_laplacian_smoothing")
        if self.has_loss("lambda_opacity_max"):
            om = torch.mean((1.0 - gaussian_strengths(gs.params)) ** 2)
            logs["train/loss_opacity_max"] = om
            total = total + om * self.loss_lambda(sched, "lambda_opacity_max")
        if (self.has_loss("lambda_normal_depth_consistency") and out is not None
                and "comp_normal" in out and "comp_normal_from_dist" in out):
            ndc = torch.mean(((out["comp_normal"] * 2.0 - 1.0)
                              - (out["comp_normal_from_dist"] * 2.0 - 1.0)) ** 2)
            logs["train/loss_normal_depth_consistency"] = ndc
            total = total + ndc * self.loss_lambda(sched, "lambda_normal_depth_consistency")
        if self.has_loss("lambda_tv_loss") and out is not None:
            tv = tv_loss(out["comp_rgb"])
            logs["train/loss_tv"] = tv
            total = total + tv * self.loss_lambda(sched, "lambda_tv_loss")
        if out is not None:
            total = self.tv_trio_losses(out, sched, logs, total)
        logs["train/loss_total"] = total
        logs["n_faces"] = gs.n_faces
        return total, logs, outs, torch.zeros((0, 2), device=self.device, requires_grad=True)

    def train_step(self, state: SystemState, batch, step: int, generator: torch.Generator):
        self._draws = self.step_draws(step) if self.step_draws is not None else {}
        # the gaussian stage's density / SDF regularisers read a k-NN table
        # refreshed on the host every reset_neighbors_every steps
        if self.cfg.stage == "gaussian" and (self.has_loss("lambda_density_regulation")
                                             or self.has_loss("lambda_normal_regulation")):
            self._refresh_knn(state, step)
        return super().train_step(state, batch, step, generator)

    def predict_textured_mesh(self, state, views, out_path: str, stats=None):
        """--predict: bake a textured OBJ of the mesh, its border faces of
        low density peeled first where ``postprocess`` is set.  ``stats``,
        where given, collects the bake's stage times and counters."""
        from ..models.texture_bake import extract_textured_mesh

        stats = {} if stats is None else stats
        stats["faces_before"] = state.gauss.n_faces
        if self.cfg.postprocess:
            new_gauss = self.geometry.postprocess_state(
                state.gauss, density_threshold=self.cfg.postprocess_density_threshold,
                iterations=self.cfg.postprocess_iterations)
            state = dataclasses.replace(state, gauss=new_gauss)
        stats["faces_after"] = state.gauss.n_faces
        return extract_textured_mesh(
            self.geometry, state.gauss, lambda vs: self.render_views(state, vs), views, out_path,
            square_size=self.geometry.cfg.square_size_in_texture, stats=stats)
