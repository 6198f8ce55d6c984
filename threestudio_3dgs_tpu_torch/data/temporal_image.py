"""Temporal (video) reference data for 4D generation (port of the JAX
package's ``data/temporal_image.py``, ``temporal-image-datamodule``).

Per-frame RGBA images composited over white (or, without a frames
directory, a synthetic bright square moving down the diagonal), a random
subset of ``num_frames`` frames per batch in frame order with their
timestamps, from the module's own ``np.random.default_rng(seed)`` drawn as
the JAX package draws it, and the random cameras, ``num_frames`` times the
configured batch, with each frame's timestamp and index repeated over its
cameras.  The eval circles get timestamps spread over [0, 1].

The frames keep the first entry of ``height``/``width`` for the whole run,
as in the JAX package: the resolution milestones do not apply (the random
cameras keep their own schedule)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.config import parse_structured
from ..utils.registry import register
from .image import SingleImageDataModule, SingleImageDataModuleConfig, _load_rgba
from .uncond import fixed_circle_views


@dataclasses.dataclass
class TemporalRandomImageDataModuleConfig(SingleImageDataModuleConfig):
    video_frames_dir: Optional[str] = None
    video_length: int = 14
    num_frames: int = 14
    norm_timestamp: bool = False
    white_background: bool = True


@register("temporal-image-datamodule")
class TemporalImageDataModule(SingleImageDataModule):
    Config = TemporalRandomImageDataModuleConfig

    def __init__(self, cfg=None, seed: int = 0, device=None, **kwargs):
        if cfg is None:
            cfg = TemporalRandomImageDataModuleConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(TemporalRandomImageDataModuleConfig, cfg)
        self.rng = np.random.default_rng(seed)
        # one camera batch per frame
        rc = dict(cfg.random_camera)
        self.rand_cam_bs = int(rc.get("batch_size", 1))
        rc["batch_size"] = cfg.num_frames * self.rand_cam_bs
        self.frame_indices = np.arange(cfg.video_length, dtype=np.int32)
        denom = cfg.video_length if cfg.norm_timestamp else max(cfg.video_length - 1, 1)
        self.timestamps = (self.frame_indices / denom).astype(np.float32)
        super().__init__(dataclasses.replace(cfg, random_camera=rc), seed, device)

    def _load_images(self) -> None:
        """Every frame at the current size: ``<i:03>_rgba.png`` (else
        ``<i>.png``) from the frames directory, or the synthetic square."""
        cfg = self.cfg
        rgbs, masks = [], []
        for idx in range(cfg.video_length):
            if cfg.video_frames_dir and os.path.isdir(cfg.video_frames_dir):
                path = os.path.join(cfg.video_frames_dir, f"{idx:03}_rgba.png")
                if not os.path.exists(path):
                    path = os.path.join(cfg.video_frames_dir, f"{idx}.png")
                rgba = _load_rgba(path, self.width, self.height)
            else:
                rgba = np.zeros((self.height, self.width, 4), np.float32)
                s = self.height // 4
                off = int((idx / max(cfg.video_length - 1, 1)) * (self.height - s))
                rgba[off: off + s, off: off + s] = [0.8, 0.4, 0.2, 1.0]
            rgb = rgba[..., :3]
            mask = (rgba[..., 3:] > 0.5).astype(np.float32)
            if cfg.white_background:
                rgb = rgb * mask + (1.0 - mask)
            rgbs.append(rgb)
            masks.append(mask)
        self.rgbs = np.stack(rgbs)
        self.masks = np.stack(masks)

    def train_batch(self, global_step: int) -> Dict[str, Any]:
        cfg = self.cfg
        idx = np.sort(self.rng.choice(cfg.video_length, (cfg.num_frames,), replace=False))
        timestamps = self.timestamps[idx]
        frame_indices = self.frame_indices[idx]
        nf = cfg.num_frames
        batch = {
            "rays_o": np.repeat(self.rays_o, nf, axis=0),
            "rays_d": np.repeat(self.rays_d, nf, axis=0),
            "mvp_mtx": np.repeat(self.mvp, nf, axis=0),
            "camera_positions": self.camera_position,
            "light_positions": self.camera_position,
            "elevation": self.elevation_deg,
            "azimuth": self.azimuth_deg,
            "camera_distances": self.distance,
            "rgb": self.rgbs[idx],
            "mask": self.masks[idx],
            "ref_depth": None,
            "ref_normal": None,
            "height": self.height,
            "width": self.width,
            "c2w": np.repeat(self.c2w, nf, axis=0),
            "fovy": np.repeat(self.fovy, nf),
            "timestamp": timestamps,
            "frame_indices": frame_indices,
        }
        if self.random_sampler is not None:
            self.random_sampler.update_step(global_step)
            rand = self.random_sampler.sample()
            rand["timestamp"] = np.repeat(timestamps, self.rand_cam_bs)
            rand["frame_indices"] = np.repeat(frame_indices, self.rand_cam_bs)
            batch["random_camera"] = rand
        return batch

    def val_views(self):
        return self._with_time(fixed_circle_views(self.random_camera_cfg, "val"))

    def test_views(self):
        return self._with_time(fixed_circle_views(self.random_camera_cfg, "test"))

    def _with_time(self, views: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        n = len(views)
        for i, v in enumerate(views):
            t = i / max(n - 1, 1)
            v["timestamp"] = np.array([t], np.float32)
            v["frame_indices"] = np.array(
                [min(int(t * self.cfg.video_length), self.cfg.video_length - 1)], np.int32)
        return views
