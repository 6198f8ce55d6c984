"""Plain reference of the video-to-4D motion step the ``gs4d.motion`` cell
times (``gaussian-splatting-4dgen-system`` in its ``motion`` stage with
the ``temporal-stable-zero123-guidance``, as ``gs4d_motion.yaml``
configures it: threestudio-3dgs's 4DGen recipe with Stable Zero123,
Liu et al. 2023 / stabilityai/stable-zero123), in float32 under autograd,
built on ``splat.py``, ``diffusion.py`` and ``clip_vision.py``.

The conditioning, from the frame files (``<i:03>_rgba.png``; RGB over
white where the alpha is at most one half, the mask alpha > 1/2):

  * each frame's CLIP ViT-L/14 image embedding (``clip_vision.py``);
  * ``c_concat``: the unscaled posterior mode of the VAE encoder on the
    frame resized to ``cond_image_size``;
  * each guided view's context: ``cc_projection`` (772 -> 768) over
    [its frame's embedding | the stable variant's camera: d_elevation,
    sin d_azimuth, cos d_azimuth (d_azimuth mod 360), deg2rad(90 -
    cond_elevation), all in radians], one token.

The field: the random sphere (``splat.sphere_init``) with zero ``motion``
(rank 3), ``omega`` (rank 1) and ``trbf_center`` and ``trbf_scale`` at
``trbfslinit``.  A view at time t renders the positions xyz + sum_i
motion_i dt^(i+1) and the quaternions rotation + omega dt, with dt =
t - trbf_center taken without gradient, and the colours SH2RGB(f_dc)
(unclamped); so ``trbf_center`` and ``trbf_scale`` take no gradient.

The step, in one backward:

  * the random views (each at its frame's timestamp), the background
    white unless the view's draw exceeds ``invert_bg_prob``; Zero123 SDS:
    the render resized to ``cond_image_size``, VAE-encoded and sampled,
    one timestep a view in [min, max]_step_percent of 1000, the CFG pair
    [zero context and zero ``c_concat`` | the view's] through the UNet,
    guidance scale 3, w(t) = 1 - alpha_bar, times ``lambda_sds_zero123``;
  * the reference renders at the fixed front camera, one a sampled frame
    at its timestamp: mean squared error of the masked RGB and of the mask
    against the frame's, times ``lambda_rgb`` and ``lambda_mask``;
  * the anchor: the live points' mean squared distance between their
    positions at the first sampled frame's time and the canonical ones,
    times ``lambda_ref_gs``;
  * the lite ARAP between the positions at that time (no gradient) and at
    a drawn time, over each point's 8 nearest neighbours (self excluded,
    found on the canonical positions every ``freq.update_arap`` steps),
    with each point's rotation fitted by SVD without gradient, over the
    live count, times ``lambda_lite_arap_reg`` (0 before step 300 in the
    YAML, so the cell's steps add it times 0);
  * Adam on every leaf at its field's learning rate (eps 1e-15).

The draws of a step are handed in (``train.Draws``), in the order the
step takes them: each random view's background draw, the VAE's latent
noise, the timesteps, the SDS noise, each reference view's background
draw, the ARAP's time.  ``${a.b}`` interpolations of the YAML are
resolved here; values it leaves out take the program's defaults.

Departures from the published models, as in ``diffusion.py``: none in
the reference; the program's GEGLU takes the tanh GELU and its VAE
resnets epsilon 1e-5."""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Any, Dict

import numpy as np
import torch

from . import clip_vision, diffusion, splat, train

GEO_DEFAULTS = {"trbfslinit": 0.1, "rank_motion": 3, "rank_omega": 1, "spatial_lr_scale": 10.0,
                "position_lr": 0.001, "feature_lr": 0.01, "opacity_lr": 0.05,
                "scaling_lr": 0.005, "rotation_lr": 0.005, "move_lr": 0.01, "omega_lr": 0.01,
                "trbfc_lr": 0.01, "trbfs_lr": 0.01}
GUIDANCE_DEFAULTS = {"guidance_scale": 3.0, "cond_elevation_deg": 0.0, "cond_azimuth_deg": 0.0,
                     "cond_image_size": 256}
LR_NAMES = {"xyz": "position_lr", "features_dc": "feature_lr", "scaling": "scaling_lr",
            "rotation": "rotation_lr", "opacity": "opacity_lr", "motion": "move_lr",
            "omega": "omega_lr", "trbf_center": "trbfc_lr", "trbf_scale": "trbfs_lr"}
REF = re.compile(r"^\$\{([A-Za-z0-9_.]+)\}$")


def ever(value) -> bool:
    """Whether a scheduled lambda is above 0 at some step (the system adds
    its term, times the step's value, when it is)."""
    if isinstance(value, (int, float)):
        return value > 0
    v = [0] + list(value) if len(value) == 3 else list(value)
    return max([v[1]] + v[2::2]) > 0


def resolve(cfg: Any, root: Any = None) -> Any:
    """The YAML with each value that is exactly ``${a.b.c}`` replaced by the
    value at that path (recursively); other strings, and references to a
    path the YAML does not hold, are left alone."""
    root = cfg if root is None else root
    if isinstance(cfg, dict):
        return {k: resolve(v, root) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [resolve(v, root) for v in cfg]
    m = REF.match(cfg) if isinstance(cfg, str) else None
    if not m:
        return cfg
    node = root
    for key in m.group(1).split("."):
        if not isinstance(node, dict) or key not in node:
            return cfg
        node = node[key]
    return resolve(node, root)


# ---------------------------------------------------------------------------
# The frames
# ---------------------------------------------------------------------------


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 of an 8-bit RGB or RGBA PNG without interlacing or
    row filters, as ``kinds/zero123-4d.py`` writes the frames."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB / RGBA without interlacing")
    c = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter (the benchmark writes none)")
    return raw[:, 1:].reshape(h, w, c).copy()


def load_frames(directory: str, n: int, size: int):
    """(rgb (n, size, size, 3) over white, mask (n, size, size, 1)) of the
    frames ``<i:03>_rgba.png``, each written at ``size``."""
    rgbs, masks = [], []
    for i in range(n):
        img = read_png(os.path.join(directory, f"{i:03}_rgba.png"))
        if img.shape[:2] != (size, size):
            raise ValueError(f"frame {i} is {img.shape[:2]}, not the data's {size}^2")
        rgba = img.astype(np.float32) / 255.0
        if rgba.shape[-1] == 3:
            rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], axis=-1)
        mask = (rgba[..., 3:] > 0.5).astype(np.float32)
        rgbs.append(rgba[..., :3] * mask + (1.0 - mask))
        masks.append(mask)
    return np.stack(rgbs), np.stack(masks)


# ---------------------------------------------------------------------------
# The lite ARAP
# ---------------------------------------------------------------------------


def knn(points: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) indices of each point's k nearest other points (float64)."""
    p = points.double()
    d2 = torch.cdist(p, p) ** 2
    d2.fill_diagonal_(float("inf"))
    return torch.topk(d2, k, dim=1, largest=False).indices


def arap_energy(rest: torch.Tensor, deformed: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """sum_i sum_j |(p'_i - p'_j) - R_i (p_i - p_j)|^2 over the neighbour
    table, R_i the rotation that best maps the rest edges onto the deformed
    ones (SVD of their covariance, the reflection corrected; no
    gradient)."""
    e_rest = rest[:, None, :] - rest[nbrs]
    e_def = deformed[:, None, :] - deformed[nbrs]
    with torch.no_grad():
        cov = e_rest.transpose(1, 2) @ e_def  # sum_j rest_j def_j^T
        u, _, vt = torch.linalg.svd(cov)
        v = vt.transpose(1, 2)
        flip = torch.ones_like(cov[:, 0])
        flip[:, 2] = torch.where(torch.linalg.det(v @ u.transpose(1, 2)) < 0, -1.0, 1.0)
        rot = v @ torch.diag_embed(flip) @ u.transpose(1, 2)
    diff = e_def - e_rest @ rot.transpose(1, 2)
    return torch.sum(diff * diff)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


class VideoTo4D:
    """The motion-stage step of ``gaussian-splatting-4dgen-system`` with
    the temporal Stable Zero123 guidance; ``weights`` holds the ``unet``,
    ``vae``, ``image_encoder`` and ``clip_camera_projection`` state dicts
    and ``model`` the configuration (their ``config.json`` groups)."""

    def __init__(self, yaml_cfg: dict, model: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 device, precision: diffusion.Precision = diffusion.F32):
        cfg = resolve(yaml_cfg)
        self.sys, data = cfg["system"], cfg["data"]
        self.geo = {**GEO_DEFAULTS, **self.sys["geometry"]}
        self.g = {**GUIDANCE_DEFAULTS, **self.sys["guidance_zero123"]}
        self.lam = self.sys["loss"]
        self.freq = self.sys.get("freq") or {}
        self.model, self.W, self.device, self.P = model, weights, device, precision
        self.ac = train.alphas_cumprod(device)
        size = data["height"][0] if isinstance(data["height"], list) else data["height"]
        rgb, mask = load_frames(data["video_frames_dir"], int(data["video_length"]), int(size))
        self.rgb = torch.as_tensor(rgb, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.csz = int(self.g["cond_image_size"])
        with torch.no_grad():
            self.clip = clip_vision.image_embeds(weights["image_encoder"], model["image_encoder"],
                                                 self.rgb, precision)
            moments = self._encode(self.rgb)
            self.c_concat = moments[:, : moments.shape[1] // 2]

    def _encode(self, rgb: torch.Tensor) -> torch.Tensor:
        x = clip_vision.resize((rgb * 2.0 - 1.0).permute(0, 3, 1, 2), self.csz)
        return diffusion.vae_encode(self.W["vae"], self.model["vae"], x, self.P)

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int) -> Dict[str, Any]:
        geo = self.geo
        field = {k: torch.as_tensor(v, device=self.device) for k, v in splat.sphere_init(
            geo["init_num_pts"], geo["pc_init_radius"], geo["opacity_init"], seed).items()}
        n = field["xyz"].shape[0]
        zeros = lambda c: torch.zeros((n, c), device=self.device)  # noqa: E731
        field.update(motion=zeros(3 * geo["rank_motion"]), omega=zeros(4 * geo["rank_omega"]),
                     trbf_center=zeros(1),
                     trbf_scale=torch.full((n, 1), float(geo["trbfslinit"]), device=self.device))
        return {"field": field, "count": 0, "nbrs": None, "nbrs_step": None,
                "adam": {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in field.items()}}

    @staticmethod
    def flat(state) -> Dict[str, torch.Tensor]:
        return dict(state["field"])

    def lrs(self, step: int) -> Dict[str, float]:
        lr = {k: float(np.float32(train.C(self.geo[name], step, "exp")))
              for k, name in LR_NAMES.items()}
        lr["xyz"] = float(np.float32(lr["xyz"]) * np.float32(self.geo["spatial_lr_scale"]))
        return lr

    # -- the field at a time -------------------------------------------------------
    def timed(self, f, t: float):
        """(means, scales, quaternions, opacities, colours) at time t."""
        n = f["xyz"].shape[0]
        dt = (torch.full((n, 1), float(t), device=self.device) - f["trbf_center"]).detach()
        motion = f["motion"].reshape(n, -1, 3)
        omega = f["omega"].reshape(n, -1, 4)
        xyz, rot = f["xyz"], f["rotation"]
        for i in range(motion.shape[1]):
            xyz = xyz + motion[:, i] * dt ** (i + 1)
        for i in range(omega.shape[1]):
            rot = rot + omega[:, i] * dt ** (i + 1)
        colors = f["features_dc"][:, 0] * splat.SH_C0 + 0.5
        return xyz, torch.exp(f["scaling"]), rot, torch.sigmoid(f["opacity"])[:, 0], colors

    def render(self, f, views: dict, draws: train.Draws):
        """{"rgb" (B, H, W, 3) over the kernel background, "mask" (B, H, W,
        1)} of each view at its own timestamp."""
        h, w = splat.image_shape(views)
        rgbs, masks = [], []
        white = torch.ones(3, device=self.device)
        for i in range(views["c2w"].shape[0]):
            cam = splat.camera(views["c2w"][i], float(views["fovy"][i]), h, w, self.device)
            xyz, scales, quats, opac, colors = self.timed(f, float(views["timestamp"][i]))
            out = splat.render(xyz, scales, quats, opac, colors, cam)
            alpha = out["alpha"][..., None]
            u = draws.pop("rand")
            bg = torch.where(u > float(self.sys["renderer"].get("invert_bg_prob", 1.0)),
                             1.0 - white, white)
            rgbs.append(torch.clamp(out["image"] + (1.0 - alpha) * bg, 0.0, 1.0))
            masks.append(alpha)
        return {"rgb": torch.stack(rgbs), "mask": torch.stack(masks)}

    # -- the guidance --------------------------------------------------------------
    def camera(self, views: dict) -> torch.Tensor:
        def get(name):
            return torch.as_tensor(np.asarray(views[name], np.float32), device=self.device)

        g = self.g
        d_elev = get("elevation") - float(g["cond_elevation_deg"])
        d_azim = torch.remainder(get("azimuth") - float(g["cond_azimuth_deg"]), 360.0)
        fourth = torch.full_like(d_elev, np.deg2rad(90.0 - float(g["cond_elevation_deg"])))
        return torch.stack([torch.deg2rad(d_elev), torch.sin(torch.deg2rad(d_azim)),
                            torch.cos(torch.deg2rad(d_azim)), fourth], dim=-1)

    def sds(self, rgb: torch.Tensor, views: dict, draws: train.Draws) -> torch.Tensor:
        b = rgb.shape[0]
        latents = diffusion.sample_latents(self._encode(rgb), draws.pop("randn"),
                                           self.model["vae"]["scaling_factor"])
        t = draws.pop("randint").to(self.device)
        noise = draws.pop("randn").to(self.device)
        ab = self.ac[t].reshape(b, 1, 1, 1)
        noisy = torch.sqrt(ab) * latents.detach() + torch.sqrt(1.0 - ab) * noise
        idx = torch.as_tensor(np.asarray(views["frame_indices"]), dtype=torch.int64,
                              device=self.device)
        W = self.W["clip_camera_projection"]
        ctx = self.P.linear(torch.cat([self.clip[idx], self.camera(views)], dim=-1),
                            W["proj.weight"], W["proj.bias"])[:, None, :]
        concat = self.c_concat[idx]
        with torch.no_grad():
            eps = diffusion.unet_forward(
                self.W["unet"], self.model["unet"],
                torch.cat([torch.cat([noisy, torch.zeros_like(concat)], 1),
                           torch.cat([noisy, concat], 1)]),
                torch.cat([t, t]), torch.cat([torch.zeros_like(ctx), ctx]), None, self.P)
        uncond, cond = eps[:b], eps[b:]
        pred = uncond + float(self.g["guidance_scale"]) * (cond - uncond)
        grad = torch.nan_to_num((1.0 - ab) * (pred - noise))
        return 0.5 * torch.sum((latents - (latents - grad).detach()) ** 2) / b

    # -- the step ------------------------------------------------------------------
    def loss(self, f, state, batch, step: int, draws: train.Draws) -> torch.Tensor:
        lam = {k: float(np.float32(train.C(v, step))) for k, v in self.lam.items()
               if isinstance(v, (int, float, list))}
        views = batch["random_camera"]
        out_z = self.render(f, views, draws)
        total = lam.get("lambda_sds_zero123", lam.get("lambda_sds", 0.0)) * self.sds(
            out_z["rgb"], views, draws)
        out = self.render(f, batch, draws)
        idx = torch.as_tensor(np.asarray(batch["frame_indices"]), dtype=torch.int64,
                              device=self.device)
        gt_mask = self.mask[idx]
        total = total + lam.get("lambda_rgb", 0.0) * torch.mean(
            (self.rgb[idx] * gt_mask - out["rgb"] * gt_mask) ** 2)
        total = total + lam.get("lambda_mask", 0.0) * torch.mean((gt_mask - out["mask"]) ** 2)
        n = f["xyz"].shape[0]
        xyz_t = self.timed(f, float(batch["timestamp"][0]))[0]
        if ever(self.lam.get("lambda_ref_gs", 0.0)):
            anchor = torch.sum((xyz_t - f["xyz"]) ** 2) / n
            total = total + lam["lambda_ref_gs"] * anchor
        if state["nbrs"] is not None:
            xyz_r = self.timed(f, float(draws.pop("rand")))[0]
            total = total + lam.get("lambda_lite_arap_reg", 0.0) * arap_energy(
                xyz_t.detach(), xyz_r, state["nbrs"]) / n
        return total

    def step(self, state, batch, step: int, draws: train.Draws):
        """One training step in place: (the total loss, the gradients by
        leaf as Adam takes them)."""
        if ever(self.lam.get("lambda_lite_arap_reg", 0.0)):
            every = int(self.freq.get("update_arap", 500))
            if state["nbrs"] is None or step - state["nbrs_step"] >= every:
                state["nbrs"] = knn(state["field"]["xyz"], int(self.freq.get("arap_k", 8)))
                state["nbrs_step"] = step
        f = {k: v.detach().requires_grad_(True) for k, v in state["field"].items()}
        total = self.loss(f, state, batch, step, draws)
        grads = dict(zip(f, torch.autograd.grad(total, list(f.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(f[k]) if g is None else g for k, g in grads.items()}
        self.adam(state, grads, self.lrs(step))
        return float(total.detach()), grads

    # Adam as the text-to-3D reference takes it: eps 1e-15 on the field's leaves
    adam = train.TextTo3D.adam
