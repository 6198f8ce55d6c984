"""Zero123 guidance (port of the JAX package's
``guidance/temporal_zero123.py``): frame-conditioned SDS for image-to-3D
(``stable-zero123-guidance``, ``zero123-guidance``) and 4D
(``temporal-zero123-guidance``, ``temporal-stable-zero123-guidance``).

  * camera conditioning: [d_elev, sin(d_azim), cos(d_azim), d_dist] in
    radians against the conditioning view; the stable variants replace the
    fourth channel by deg2rad(90 - cond_elevation);
  * ``zero123_context``: the frame's CLIP image embedding concatenated with
    the camera, through the ``cc_projection`` linear (772 -> 768), one
    token per view;
  * the SDS math of ``guidance/sds.py``.

Until ``prepare_embeddings(frames)`` builds a denoiser, an analytic prior
drives the SDS: its clean image is the frame's mean colour, 0.5 grey before
any frame is given (the single-image system never calls it, as in the JAX
package).  ``prepare_embeddings`` with ``pretrained_model_name_or_path``
(a) a diffusers-layout directory (``unet/``, ``vae/``, ``image_encoder/``
[, ``clip_camera_projection/``]) or (b) a CompVis/ldm ``.ckpt``
(``stable_zero123.ckpt``: UNet, VAE and ``cc_projection`` in one file,
the CLIP embeddings from a sibling ``image_encoder/`` or, without one, the
JAX package's stand-in embeddings, ``np.random.default_rng(0)`` normals x
0.1) builds the real one:

  * the UNet and VAE configs read off the state dicts' shapes; with
    ``half_precision_weights`` (the default) both compute in bf16 with f32
    norms, and the UNet's level-0 self-attention (1024 tokens of d = 40 at
    the 256^2 conditioning size) runs K5 on the card;
  * ``c_concat``: the unscaled posterior mode of each frame resized to
    ``cond_image_size``; ``c_crossattn``: its CLIP image embedding
    (``guidance/clip.py`` ``ImageEncoder``, once per frame);
  * the CFG pair [uncond | cond] with a zero unconditional context and a
    zero ``c_concat``; the renders are resized to ``cond_image_size`` and
    encoded by the VAE (differentiable) before the SDS.

Deliberate differences: where ``image_encoder/`` exists but does not
load, the port raises (the JAX package falls back on any exception), as
the port's CLIP text encoder does; without the directory both behave
alike.  A checkpoint file that loads but holds no ldm UNet raises too (the
JAX package takes its analytic prior): a run never trains against the
prior when it was given a checkpoint."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from ..utils.config import parse_structured
from ..utils.registry import register
from .base import BaseGuidance
from .sds import SDSConfig, ddpm_alphas_cumprod, sds_loss, sds_sched_scalars


def zero123_context(clip_emb: torch.Tensor, cam_emb: torch.Tensor, cc_w: torch.Tensor,
                    cc_b: torch.Tensor) -> torch.Tensor:
    """(B, 768) CLIP image embeddings and (B, 4) cameras -> (B, 1, 768):
    [clip | camera] @ cc_w + cc_b, ``cc_w`` in (in, out) layout."""
    x = torch.cat([clip_emb, cam_emb.to(clip_emb.dtype)], dim=-1)
    return (x @ cc_w + cc_b)[:, None, :]


@dataclasses.dataclass
class TemporalZero123Config:
    pretrained_model_name_or_path: str = "load/zero123/zero123-xl.ckpt"
    pretrained_config: str = ""
    vram_O: bool = True
    cond_image_path: str = ""
    cond_video_path: str = ""
    cond_elevation_deg: float = 0.0
    cond_azimuth_deg: float = 0.0
    cond_camera_distance: float = 1.2
    guidance_scale: float = 3.0
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    grad_clip: Any = None
    num_frames: int = 14
    half_precision_weights: bool = True
    cond_image_size: int = 256


def _find_weights(root: str, sub: str) -> Optional[str]:
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        path = os.path.join(root, sub, name)
        if os.path.exists(path):
            return path
    return None


def _clip_image_embeddings(directory: str, frames: np.ndarray, device) -> Optional[np.ndarray]:
    """(T, 768) projected CLIP image embeddings of the frames from the image
    tower in ``directory``, or None when there is no such directory; a
    directory that does not load raises."""
    if not os.path.isdir(directory):
        return None
    from .clip import ImageEncoder

    encoder = ImageEncoder(directory, device)
    embeddings = encoder(frames)
    del encoder
    return embeddings


class _TemporalZero123Base(BaseGuidance):
    Config = TemporalZero123Config
    stable_variant = False

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = TemporalZero123Config(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(TemporalZero123Config, cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.sds_cfg = SDSConfig(
            guidance_scale=cfg.guidance_scale,
            min_step_percent=cfg.min_step_percent,
            max_step_percent=cfg.max_step_percent,
            grad_clip=cfg.grad_clip,
        )
        self.alphas_cumprod = ddpm_alphas_cumprod(device=self.device)
        self.unet = None
        self.vae_encoder = None
        self.denoiser = None
        # per-frame conditioning; filled by prepare_embeddings
        self.cond_targets = torch.full((cfg.num_frames, 3), 0.5, device=self.device)

    # -- conditioning ---------------------------------------------------------
    def prepare_embeddings(self, frames: np.ndarray) -> None:
        """frames (T, H, W, 3) in [0, 1]: the frames' mean colours (the
        analytic prior's targets) and, where the checkpoint is a local
        directory or an ldm file, the real denoiser."""
        frames = np.asarray(frames, np.float32)
        self.cond_targets = torch.as_tensor(frames.reshape(frames.shape[0], -1, 3).mean(axis=1),
                                            device=self.device)
        path = str(self.cfg.pretrained_model_name_or_path)
        if os.path.isdir(path):
            self._try_load_local(path, frames)
        elif os.path.isfile(path) and path.endswith((".ckpt", ".safetensors", ".bin", ".pt")):
            self._try_load_ldm_ckpt(path, frames)

    def _try_load_local(self, path: str, frames: np.ndarray) -> None:
        """A diffusers-layout directory; nothing is built without ``unet/``
        and ``vae/`` weights or without ``image_encoder/``."""
        from ..diffusion.convert import load_torch_state_dict
        from ..diffusion.vae import vae_half

        unet_file, vae_file = _find_weights(path, "unet"), _find_weights(path, "vae")
        if unet_file is None or vae_file is None:
            return
        clip_embs = _clip_image_embeddings(os.path.join(path, "image_encoder"), frames,
                                           self.device)
        if clip_embs is None:
            return
        cc_w = cc_b = None
        ccp_file = _find_weights(path, "clip_camera_projection")
        if ccp_file is not None:
            ccp = load_torch_state_dict(ccp_file)
            cc_w = [v for k, v in ccp.items() if k.endswith("weight")][0].T
            cc_b = [v for k, v in ccp.items() if k.endswith("bias")][0]
        self._build_denoiser(frames, load_torch_state_dict(unet_file),
                             vae_half(load_torch_state_dict(vae_file), "encoder"),
                             clip_embs, cc_w, cc_b)

    def _try_load_ldm_ckpt(self, path: str, frames: np.ndarray) -> None:
        """A CompVis/ldm single file (zero123-xl.ckpt, stable_zero123.ckpt):
        the UNet, the VAE encoder and ``cc_projection`` from it, the CLIP
        embeddings from a sibling ``image_encoder/`` or the stand-ins."""
        from ..diffusion.convert import (
            is_ldm_state_dict, ldm_unet_to_diffusers, ldm_vae_encoder_to_diffusers,
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(path)
        if not is_ldm_state_dict(sd):
            raise ValueError(f"{path}: not a CompVis/ldm Zero123 checkpoint (no "
                             "model.diffusion_model.* UNet)")
        cc_w = cc_b = None
        if "cc_projection.weight" in sd:
            cc_w, cc_b = sd["cc_projection.weight"].T, sd["cc_projection.bias"]
        clip_embs = _clip_image_embeddings(
            os.path.join(os.path.dirname(path), "image_encoder"), frames, self.device)
        if clip_embs is None:
            # the JAX package's stand-ins, sized from cc_projection (in =
            # clip_dim + 4 camera channels)
            clip_dim = cc_w.shape[0] - 4 if cc_w is not None else 768
            rng = np.random.default_rng(0)
            clip_embs = rng.standard_normal((frames.shape[0], clip_dim)).astype(np.float32) * 0.1
        unet_sd, vae_sd = ldm_unet_to_diffusers(sd), ldm_vae_encoder_to_diffusers(sd)
        del sd
        self._build_denoiser(frames, unet_sd, vae_sd, clip_embs, cc_w, cc_b)

    def _build_denoiser(self, frames, unet_sd, vae_sd, clip_embs, cc_w, cc_b) -> None:
        """The Zero123 denoiser and encoder from diffusers-naming state
        dicts (whatever format they came from)."""
        from ..diffusion import ZERO123_UNET, SD_VAE, UNet2DCondition, VAEEncoder
        from ..diffusion.convert import (
            fast_model_config, infer_unet_config_from_state_dict, infer_vae_config_from_state_dict,
            load_frozen,
        )
        from .mvdream import resize_bilinear

        half = bool(self.cfg.half_precision_weights)
        unet_cfg = fast_model_config(infer_unet_config_from_state_dict(unet_sd, ZERO123_UNET), half)
        vae_cfg = fast_model_config(infer_vae_config_from_state_dict(vae_sd, SD_VAE), half)
        self.vae_encoder = load_frozen(VAEEncoder, vae_cfg, vae_sd, self.device, half)
        self.unet = load_frozen(UNet2DCondition, unet_cfg, unet_sd, self.device, half)
        csz = int(self.cfg.cond_image_size)
        self._cond_size = csz

        with torch.no_grad():
            x = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
            moments = self.vae_encoder(resize_bilinear((x * 2.0 - 1.0).permute(0, 3, 1, 2), csz))
            # c_concat: the unscaled posterior mode, (T, 4, csz / 8, csz / 8)
            self.cond_concat = moments[:, : moments.shape[1] // 2].float()
        self.cond_crossattn = torch.as_tensor(np.asarray(clip_embs, np.float32),
                                              device=self.device)
        if cc_w is not None:
            self.cc_w = torch.as_tensor(cc_w, device=self.device).float()
            self.cc_b = torch.as_tensor(cc_b, device=self.device).float()
        else:  # the JAX package's degenerate fallback: a slice
            self.cc_w = torch.eye(772, 768, device=self.device)
            self.cc_b = torch.zeros(768, device=self.device)
        unet = self.unet

        def denoiser(noisy, t, frame_idx, cam_emb):
            b = noisy.shape[0]
            ctx_c = zero123_context(self.cond_crossattn[frame_idx], cam_emb, self.cc_w, self.cc_b)
            concat_c = self.cond_concat[frame_idx]
            x_c = torch.cat([noisy, concat_c], dim=1)
            x_u = torch.cat([noisy, torch.zeros_like(concat_c)], dim=1)
            with torch.no_grad():
                eps = unet(torch.cat([x_u, x_c]), torch.cat([t, t]),
                           torch.cat([torch.zeros_like(ctx_c), ctx_c]))
            return eps[:b], eps[b:]

        self.denoiser = denoiser

    def encode_rgb(self, rgb, generator, latent_noise=None):
        """rgb (B, H, W, 3) in [0, 1] -> scaled latents (B, 4, s/8, s/8) of
        the render resized to s = ``cond_image_size``."""
        from ..diffusion.vae import sample_latents
        from .mvdream import resize_bilinear

        x = resize_bilinear((rgb * 2.0 - 1.0).permute(0, 3, 1, 2), self._cond_size)
        return sample_latents(self.vae_encoder(x), self.vae_encoder.cfg.scaling_factor,
                              generator, latent_noise)

    def set_denoiser(self, fn):
        """fn(noisy, t, frame_idx, cam_emb) -> (eps_uncond, eps_cond)."""
        self.denoiser = fn

    def camera_embedding(self, batch) -> torch.Tensor:
        """(B, 4) relative camera against the conditioning view, f32."""
        def get(name):
            return torch.as_tensor(np.asarray(batch[name], np.float32), device=self.device)

        d_elev = get("elevation") - self.cfg.cond_elevation_deg
        d_azim = torch.remainder(get("azimuth") - self.cfg.cond_azimuth_deg, 360.0)
        d_dist = get("camera_distances") - self.cfg.cond_camera_distance
        if self.stable_variant:
            fourth = torch.deg2rad(torch.full_like(d_elev, 90.0 - self.cfg.cond_elevation_deg))
        else:
            fourth = d_dist
        return torch.stack([torch.deg2rad(d_elev), torch.sin(torch.deg2rad(d_azim)),
                            torch.cos(torch.deg2rad(d_azim)), fourth], dim=-1)

    def sched_scalars(self, step: int) -> dict:
        return sds_sched_scalars(self.sds_cfg, step)

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None, draws=None):
        """``draws`` ({"t", "noise", "latent_noise"}, each optional) replaces
        the generator's draws; only tests pass it."""
        if generator is None:
            generator = torch.Generator(device=rgb.device).manual_seed(0)
        if sched is None:
            sched = sds_sched_scalars(self.sds_cfg, 0)
        draws = draws or {}
        ac = self.alphas_cumprod.to(rgb.device)
        frame_idx = batch.get("frame_indices")
        frame_idx = (torch.zeros(rgb.shape[0], dtype=torch.int64, device=rgb.device)
                     if frame_idx is None else
                     torch.as_tensor(np.asarray(frame_idx), dtype=torch.int64, device=rgb.device))
        cam_emb = self.camera_embedding(batch).to(rgb.device)

        if self.denoiser is not None:
            latents = rgb
            if self.vae_encoder is not None:
                latents = self.encode_rgb(rgb, generator, draws.get("latent_noise"))

            def denoise_fn(noisy, t):
                return self.denoiser(noisy, t, frame_idx, cam_emb)
        else:
            targets = self.cond_targets.to(rgb.device)[frame_idx]  # (B, 3)
            latents = rgb

            def denoise_fn(noisy, t):
                alpha_bar = ac[t].reshape((t.shape[0],) + (1,) * (noisy.dim() - 1))
                x0 = targets[:, None, None, :].expand_as(noisy)
                eps = (noisy - torch.sqrt(alpha_bar) * x0) / torch.sqrt(1.0 - alpha_bar)
                return eps, eps

        loss, aux = sds_loss(latents, denoise_fn, generator, sched, self.sds_cfg, ac,
                             t=draws.get("t"), noise=draws.get("noise"))
        return {"loss_sds": loss, "grad_norm": aux["grad_norm"]}


@register("temporal-zero123-guidance")
class TemporalZero123Guidance(_TemporalZero123Base):
    stable_variant = False


@register("temporal-stable-zero123-guidance")
class TemporalStableZero123Guidance(_TemporalZero123Base):
    stable_variant = True


@register("stable-zero123-guidance")
@register("zero123-guidance")
class StableZero123Guidance(_TemporalZero123Base):
    """Single-image zero123: frame 0's conditioning only."""

    stable_variant = True
