"""Plain reference of the text-to-3D training step the cells time
(threestudio-3dgs's SDS recipe as the cells' YAMLs configure it), in
float32 under autograd, built on ``splat.py`` and ``diffusion.py``:

  render every view of the camera batch (the kernel background white or,
  where the view's draw exceeds ``invert_bg_prob``, black; or, for the
  shading renderer, zero under the neural environment background with the
  depth normals and the albedo of the material's ambient-only phase)
  -> SDS through the VAE encoder (Stable Diffusion: one timestep a view,
  the view-dependent prompt; MVDream: one timestep a 4-view scene, the
  camera-conditioned UNet and the reconstruction loss with its std
  rescale) -> the regularisers -> Adam on the field (eps 1e-15) and on the
  background MLP (eps 1e-8).

The random draws of a step (the background inversions or augmentations,
the material's draws, the VAE's latent noise, the timesteps, the SDS noise)
are handed in, in the order the step takes them from its generator, and so
is the camera batch.  The prompt's vectors are the configuration's stand-in
for the CLIP encoder (``reduced``: ``text_encoder``): 77 x 1024 normals from
numpy's generator seeded by the CRC32 of the text.  Values the YAML leaves
out take the system's defaults, written here."""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import diffusion, splat

VIEW_SUFFIXES = (", front view", ", side view", ", back view", ", overhead view")
FIELD_DEFAULTS = {"scaling_lr": 0.005, "rotation_lr": 0.005, "color_clip": 2.0,
                  "sh_degree": 0}


def C(value: Any, step: int, interpolation: str = "linear") -> float:
    """threestudio's scheduled value at ``step``: a scalar, [v0, v1, t1],
    [t0, v0, v1, t1] (linear or, for learning rates, log-space) or the
    multi-knot [t0, v0, v1, t1, v2, t2, ...] (piecewise linear)."""
    if isinstance(value, (int, float)):
        return float(value)
    v = list(value)
    if len(v) == 3:
        v = [0] + v
    if len(v) > 4:
        knots = [(v[0], v[1])] + [(v[i + 1], v[i]) for i in range(2, len(v), 2)]
        if step <= knots[0][0]:
            return float(knots[0][1])
        for (t0, v0), (t1, v1) in zip(knots[:-1], knots[1:]):
            if step < t1:
                return v0 + (v1 - v0) * (step - t0) / max(t1 - t0, 1e-8)
        return float(knots[-1][1])
    t0, v0, v1, t1 = v
    frac = min(1.0, max(0.0, (step - t0) / max(t1 - t0, 1e-8)))
    if interpolation == "exp":
        return math.exp(math.log(max(v0, 1e-30)) * (1 - frac) + math.log(max(v1, 1e-30)) * frac)
    return v0 + (v1 - v0) * frac


def text_vectors(text: str) -> np.ndarray:
    return np.random.default_rng(zlib.crc32(text.encode("utf-8"))).normal(
        size=(77, 1024)).astype(np.float32)


def alphas_cumprod(device) -> torch.Tensor:
    """The scaled-linear DDPM schedule of Stable Diffusion (1000 steps,
    beta 0.00085 -> 0.012 in sqrt space)."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=torch.float32,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def tv(img: torch.Tensor) -> torch.Tensor:
    return (torch.mean((img[:, 1:] - img[:, :-1]) ** 2)
            + torch.mean((img[:, :, 1:] - img[:, :, :-1]) ** 2))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, zero where v is zero (with a finite gradient there)."""
    sq = (v * v).sum(-1, keepdim=True)
    zero = sq < 1e-24
    return torch.where(zero, torch.zeros_like(v),
                       v * torch.rsqrt(torch.where(zero, torch.ones_like(sq), sq)))


def depth_normals(xyz: torch.Tensor) -> torch.Tensor:
    """-cross(d/dx, d/dy) of an (H, W, 3) position map by central
    differences, zero outside the image."""
    p = F.pad(xyz, (0, 0, 1, 1, 1, 1))
    ddx = p[1:-1, 2:] - p[1:-1, :-2]
    ddy = p[2:, 1:-1] - p[:-2, 1:-1]
    return -torch.linalg.cross(ddx, ddy, dim=-1)


def sh_basis3(d: torch.Tensor) -> torch.Tensor:
    """The 9 real SH basis values of degree <= 2 (the neural background's
    ``sh_degree: 3`` encoding)."""
    x, y, z = d.unbind(-1)
    c0, c1 = 0.28209479177387814, 0.4886025119029199
    c2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
    return torch.stack([c0 * torch.ones_like(x), -c1 * y, c1 * z, -c1 * x, c2[0] * x * y,
                        c2[1] * y * z, c2[2] * (2 * z * z - x * x - y * y), c2[3] * x * z,
                        c2[4] * (x * x - y * y)], dim=-1)


class Draws:
    """The draws of one step by kind, taken in order."""

    def __init__(self, draws: List[tuple]):
        self.by_kind: Dict[str, list] = {}
        for kind, value in draws:
            self.by_kind.setdefault(kind, []).append(value)

    def pop(self, kind: str) -> torch.Tensor:
        queue = self.by_kind.get(kind, [])
        if not queue:
            raise ValueError(f"the step took fewer {kind} draws than the reference needs")
        return queue.pop(0)


class TextTo3D:
    """The step of ``gaussian-splatting-system`` with Stable Diffusion
    guidance (``kind`` "sd") or of ``gaussian-splatting-mvdream-system``
    with the MVDream guidance, shading renderer, point-light material and
    neural environment background (``kind`` "mvdream")."""

    def __init__(self, yaml_cfg: dict, model: dict, unet_w, vae_w, device,
                 precision: diffusion.Precision = diffusion.F32):
        self.kind = model["kind"]
        self.sys = yaml_cfg["system"]
        self.geo = {**FIELD_DEFAULTS, **self.sys["geometry"]}
        self.lam = self.sys["loss"]
        self.model = model
        self.unet_w, self.vae_w = unet_w, vae_w
        self.device = device
        self.P = precision
        self.ac = alphas_cumprod(device)
        g = self.sys["guidance"]
        self.scale = float(g["guidance_scale"])
        self.prompt = self.sys["prompt_processor"]["prompt"]
        self.pp = self.sys["prompt_processor"]

    # -- state -------------------------------------------------------------
    def init_state(self, seed: int) -> Dict[str, Any]:
        geo = self.geo
        leaves = {k: torch.as_tensor(v, device=self.device) for k, v in splat.sphere_init(
            geo["init_num_pts"], geo["pc_init_radius"], geo["opacity_init"], seed).items()}
        state = {"field": leaves, "bg": {}}
        if self.kind == "mvdream":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            dims = [9, 16, 16, 3]  # the background MLP: SH(2) -> 2 x 16 ReLU -> 3
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                state["bg"][f"w{i}"] = torch.randn((a, b), generator=gen,
                                                   device=self.device) * (2.0 / a) ** 0.5
                state["bg"][f"b{i}"] = torch.zeros(b, device=self.device)
        state["adam"] = {k: (torch.zeros_like(v), torch.zeros_like(v))
                         for k, v in self.flat(state).items()}
        state["count"] = 0
        return state

    @staticmethod
    def flat(state) -> Dict[str, torch.Tensor]:
        """The trained leaves by name: the field's and the background
        MLP's (``background/<name>``)."""
        return {**state["field"], **{"background/" + k: v for k, v in state["bg"].items()}}

    def lrs(self, step: int) -> Dict[str, float]:
        geo = self.geo
        lr = {"xyz": C(geo["position_lr"], step, "exp"),
              "features_dc": C(geo["feature_lr"], step, "exp"),
              "scaling": C(geo["scaling_lr"], step, "exp"),
              "rotation": C(geo["rotation_lr"], step, "exp"),
              "opacity": C(geo["opacity_lr"], step, "exp")}
        # the system's rule for the other parameters: optimizer.args.lr
        opt = self.sys.get("optimizer") or {}
        bg_lr = float((opt.get("args") or {}).get("lr") or 1e-3)
        return {**lr, **{"background/" + k: bg_lr for k in ("w0", "b0", "w1", "b1", "w2", "b2")}}

    # -- renders -----------------------------------------------------------
    def _background(self, bg, rays_d, draws: Draws):
        x = sh_basis3(rays_d)
        for i in range(3):
            x = x @ bg[f"w{i}"] + bg[f"b{i}"]
            if i < 2:
                x = torch.relu(x)
        color = torch.sigmoid(x)
        u = draws.pop("rand")
        bcfg = self.sys["background"]
        if bcfg.get("random_aug", False):
            solid = (u[1] < 0.5).float().expand_as(color)
            color = torch.where(u[0] < bcfg.get("random_aug_prob", 0.5), solid, color)
        return color

    def render(self, leaves, bg, batch, step: int, draws: Draws) -> Dict[str, torch.Tensor]:
        h, w = splat.image_shape(batch)
        clip = C(self.geo["color_clip"], step)
        colors = splat.sh0_colors(torch.clamp(leaves["features_dc"], -clip, clip))
        scales = torch.exp(leaves["scaling"])
        opac = torch.sigmoid(leaves["opacity"])[:, 0]
        rgbs, depths, masks, normals = [], [], [], []
        for i in range(batch["c2w"].shape[0]):
            cam = splat.camera(batch["c2w"][i], float(batch["fovy"][i]), h, w, self.device)
            out = splat.render(leaves["xyz"], scales, leaves["rotation"], opac, colors, cam)
            image, alpha = out["image"], out["alpha"][..., None]
            if self.kind == "sd":
                u = draws.pop("rand")
                white = torch.ones(3, device=self.device)
                kbg = torch.where(u > self.sys["renderer"].get("invert_bg_prob", 1.0),
                                  1.0 - white, white)
                rgbs.append(torch.clamp(image + (1.0 - alpha) * kbg, 0.0, 1.0))
                continue
            rays_o = torch.as_tensor(batch["rays_o"][i], device=self.device)
            rays_d = torch.as_tensor(batch["rays_d"][i], device=self.device)
            bg_color = self._background(bg, rays_d, draws)
            depth = out["depth"]
            nm = normalize(depth_normals(rays_o + depth[..., None] * rays_d)) * 0.5 * alpha + 0.5
            sure = alpha > 0.99
            normals.append(torch.where(sure, nm, nm.detach()))
            depths.append(torch.where(sure[..., 0], depth, depth.detach())[..., None])
            masks.append(alpha)
            draws.pop("rand")  # the material's soft-shading draw
            draws.pop("rand")  # its mode draws: the albedo while ambient_only holds
            albedo = torch.clamp(image / torch.clamp_min(alpha, 1e-4), 0.0, 1.0)
            rgbs.append(torch.clamp(albedo * alpha + (1.0 - alpha) * bg_color, 0.0, 1.0))
        out = {"comp_rgb": torch.stack(rgbs)}
        if depths:
            out.update(comp_depth=torch.stack(depths), comp_mask=torch.stack(masks),
                       comp_normal=torch.stack(normals))
        return out

    # -- guidance ----------------------------------------------------------
    def _latents(self, rgb, draws: Draws):
        x = (rgb * 2.0 - 1.0).permute(0, 3, 1, 2)
        moments = diffusion.vae_encode(self.vae_w, self.model["vae"], x, self.P)
        return diffusion.sample_latents(moments, draws.pop("randn"),
                                        self.model["vae"]["scaling_factor"])

    def sds(self, rgb, batch, step: int, draws: Draws) -> torch.Tensor:
        g = self.sys["guidance"]
        b = rgb.shape[0]
        latents = self._latents(rgb, draws)
        n_view = 4 if self.kind == "mvdream" else 1
        t = torch.repeat_interleave(draws.pop("randint"), n_view)
        noise = draws.pop("randn")
        ab = self.ac[t].reshape(b, 1, 1, 1)
        noisy = torch.sqrt(ab) * latents.detach() + torch.sqrt(1.0 - ab) * noise
        if self.kind == "sd":
            idx = self._view_index(batch["elevation"], batch["azimuth"])
            emb = torch.as_tensor(np.stack([text_vectors(self.prompt + VIEW_SUFFIXES[i])
                                            for i in idx]), device=self.device)
            camera = None
        else:
            emb = torch.as_tensor(text_vectors(self.prompt), device=self.device).expand(b, 77, 1024)
            c2w = torch.as_tensor(np.asarray(batch["c2w"]), dtype=torch.float32,
                                  device=self.device).clone()
            c2w[:, :3, 3] = c2w[:, :3, 3] / (c2w[:, :3, 3].norm(dim=-1, keepdim=True) + 1e-8)
            camera = torch.cat([c2w.reshape(b, 16)] * 2)
        with torch.no_grad():
            eps = diffusion.unet_forward(self.unet_w, self.model["unet"],
                                         torch.cat([noisy, noisy]), torch.cat([t, t]),
                                         torch.cat([torch.zeros_like(emb), emb]), camera, self.P)
        uncond, cond = eps[:b], eps[b:]
        pred = uncond + self.scale * (cond - uncond)
        if self.kind == "sd":
            grad = torch.nan_to_num((1.0 - ab) * (pred - noise))
            return 0.5 * torch.sum((latents - (latents - grad).detach()) ** 2) / b
        s1, s0 = torch.sqrt(1.0 - ab), torch.sqrt(ab)
        recon = (noisy - s1 * pred) / s0
        rescale = float(g.get("recon_std_rescale", 0.5))
        if rescale > 0:
            scenes = b // n_view
            plain = (noisy - s1 * cond) / s0
            std = recon.reshape(scenes, -1).std(dim=1, correction=0) + 1e-8
            factor = (plain.reshape(scenes, -1).std(dim=1, correction=0) / std)
            adjusted = (recon.reshape(scenes, n_view, -1) * factor[:, None, None]).reshape(recon.shape)
            recon = rescale * adjusted + (1 - rescale) * recon
        return 0.5 * torch.mean(torch.sum((latents - recon.detach()) ** 2, dim=(1, 2, 3)))

    def _view_index(self, elevation, azimuth) -> np.ndarray:
        azim = (np.asarray(azimuth) + 180.0) % 360.0 - 180.0
        front = np.abs(azim) < float(self.pp.get("front_threshold", 30.0))
        back = np.abs(azim) > 180.0 - float(self.pp.get("back_threshold", 30.0))
        idx = np.where(front, 0, np.where(back, 2, 1))
        return np.where(np.asarray(elevation) > float(self.pp.get("overhead_threshold", 60.0)),
                        3, idx)

    # -- step --------------------------------------------------------------
    def loss(self, leaves, bg, batch, step: int, draws: Draws) -> torch.Tensor:
        lam = {k: C(v, step) for k, v in self.lam.items() if isinstance(v, (int, float, list))}
        out = self.render(leaves, bg, batch, step, draws)
        total = lam.get("lambda_sds", 0.0) * self.sds(out["comp_rgb"], batch, step, draws)
        n = leaves["xyz"].shape[0]
        if lam.get("lambda_position", 0) > 0:
            total = total + lam["lambda_position"] * leaves["xyz"].norm(dim=-1).sum() / n
        scaling = torch.exp(leaves["scaling"])
        if lam.get("lambda_opacity", 0) > 0:
            total = total + lam["lambda_opacity"] * torch.sum(
                scaling.norm(dim=-1).detach() * torch.sigmoid(leaves["opacity"])[:, 0])
        if lam.get("lambda_scales", 0) > 0:
            total = total + lam["lambda_scales"] * scaling.sum()
        if lam.get("lambda_tv_loss", 0) > 0:
            total = total + lam["lambda_tv_loss"] * tv(out["comp_rgb"])
        if lam.get("lambda_depth_tv_loss", 0) > 0 and "comp_depth" in out:
            total = total + lam["lambda_depth_tv_loss"] * (tv(out["comp_depth"])
                                                           + tv(out["comp_normal"]))
        if lam.get("lambda_sparsity", 0) > 0 and "comp_mask" in out:
            total = total + lam["lambda_sparsity"] * out["comp_mask"].mean()
        return total

    def step(self, state, batch, step: int, draws: Draws):
        """One training step in place: returns (the total loss, the
        gradients by leaf as Adam takes them)."""
        flat = {k: v.detach().requires_grad_(True) for k, v in self.flat(state).items()}
        field = {k: flat[k] for k in state["field"]}
        bg = {k: flat["background/" + k] for k in state["bg"]}
        total = self.loss(field, bg, batch, step, draws)
        grads = dict(zip(flat, torch.autograd.grad(total, list(flat.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(flat[k]) if g is None else g for k, g in grads.items()}
        self.adam(state, grads, self.lrs(step))
        return float(total.detach()), grads

    @torch.no_grad()
    def adam(self, state, grads, lrs) -> None:
        state["count"] += 1
        t = state["count"]
        for k, p in self.flat(state).items():
            eps = 1e-8 if k.startswith("background/") else 1e-15
            m, v = state["adam"][k]
            m.mul_(0.9).add_(0.1 * grads[k])
            v.mul_(0.999).add_(0.001 * grads[k] * grads[k])
            p.sub_(lrs[k] * (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t)) + eps))
