"""Random-camera sampling for unconditioned (text-to-3D) training.

A copy of the JAX package's ``data/uncond.py`` (numpy only, so both
packages draw identical batches from one seed).  NumPy re-implementation
of the reference's random-camera data module
(reference data/uncond.py:28-700): spherical sampling with pole-biased or
uniform-on-sphere elevation, batch-uniform azimuth stratification, camera /
center / up perturbations, two light strategies, progressive view-range
widening, resolution milestones, and the fixed-circle val/test datasets.
Batches are numpy dicts, but for a sampler given a ``device``: its
per-pixel ``rays_o`` / ``rays_d`` are then built there from the drawn
``c2w`` and ``fovy`` (:func:`device_rays`), and only the draws stay on the
host.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.config import parse_structured
from ..utils.registry import register
from ..utils.tracing import span


@dataclasses.dataclass
class RandomCameraDataModuleConfig:
    # mirrors reference data/uncond.py:28-67
    height: Any = 64
    width: Any = 64
    batch_size: Any = 1
    resolution_milestones: List[int] = dataclasses.field(default_factory=list)
    eval_height: int = 512
    eval_width: int = 512
    eval_batch_size: int = 1
    n_val_views: int = 1
    n_test_views: int = 120
    n_predict_views: int = 800
    elevation_range: Tuple[float, float] = (-10, 90)
    azimuth_range: Tuple[float, float] = (-180, 180)
    camera_distance_range: Tuple[float, float] = (1, 1.5)
    fovy_range: Tuple[float, float] = (40, 70)
    camera_perturb: float = 0.1
    center_perturb: float = 0.2
    up_perturb: float = 0.02
    light_position_perturb: float = 1.0
    light_distance_range: Tuple[float, float] = (0.8, 1.5)
    eval_elevation_deg: float = 15.0
    eval_camera_distance: float = 1.5
    eval_fovy_deg: float = 70.0
    light_sample_strategy: str = "dreamfusion"
    batch_uniform_azimuth: bool = True
    progressive_until: int = 0
    predict_height: int = 512
    predict_width: int = 512
    predict_azimuth_range: Tuple[float, float] = (-180, 180)
    predict_elevation_range: Tuple[float, float] = (-10, 80)
    predict_camera_distance_range: Tuple[float, float] = (1.5, 2.0)
    rays_d_normalize: bool = True


def _normalize(v, axis=-1, eps=1e-12):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), eps)


def spherical_to_position(elevation_rad, azimuth_rad, distance):
    """Right-handed, z up, azimuth from +x toward +y (reference :213-223)."""
    return np.stack(
        [
            distance * np.cos(elevation_rad) * np.cos(azimuth_rad),
            distance * np.cos(elevation_rad) * np.sin(azimuth_rad),
            distance * np.sin(elevation_rad),
        ],
        axis=-1,
    ).astype(np.float32)


def build_c2w(camera_positions, center=None, up=None):
    """OpenGL-style c2w batch from lookat geometry (reference :306-316)."""
    b = camera_positions.shape[0]
    if center is None:
        center = np.zeros_like(camera_positions)
    if up is None:
        up = np.tile(np.array([0, 0, 1], np.float32), (b, 1))
    lookat = _normalize(center - camera_positions)
    right = _normalize(np.cross(lookat, up))
    up2 = _normalize(np.cross(right, lookat))
    c2w = np.zeros((b, 4, 4), np.float32)
    c2w[:, :3, 0] = right
    c2w[:, :3, 1] = up2
    c2w[:, :3, 2] = -lookat
    c2w[:, :3, 3] = camera_positions
    c2w[:, 3, 3] = 1.0
    return c2w


def rays_from_c2w(c2w, fovy_rad, height, width, normalize=True):
    """Batched pixel-center rays (reference :317-334 semantics)."""
    b = c2w.shape[0]
    focal = 0.5 * height / np.tan(0.5 * fovy_rad)  # (B,)
    xs = np.arange(width, dtype=np.float32) + 0.5
    ys = np.arange(height, dtype=np.float32) + 0.5
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    dirs = np.stack(
        [gx - width * 0.5, -(gy - height * 0.5), -np.ones_like(gx)], axis=-1
    )  # (H, W, 3), unit focal
    dirs = np.tile(dirs[None], (b, 1, 1, 1))
    dirs[..., :2] /= focal[:, None, None, None]
    rays_d = np.einsum("bhwc,brc->bhwr", dirs, c2w[:, :3, :3])
    if normalize:
        rays_d = _normalize(rays_d)
    rays_o = np.broadcast_to(c2w[:, None, None, :3, 3], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def pixel_grid(height, width, device):
    """The unit-focal pixel centres' offsets from the image centre that
    :func:`rays_from_c2w`'s meshgrid holds: x (W,) and y (H,), on ``device``."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return xs - width * 0.5, -(ys - height * 0.5)


def device_rays(c2w, fovy_rad, height, width, normalize, grid):
    """:func:`rays_from_c2w`'s rays built on the device of ``grid``
    (:func:`pixel_grid`) from the host's (B, 4, 4) ``c2w`` and (B,) ``fovy``.

    The B rotations, origins and focal lengths go over in one non-blocking
    copy (from pinned memory to a card), so the build reads nothing back.
    ``rays_d`` is the unit-focal grid rotated by ``c2w[:, :3, :3]`` in f32
    products and sums, as numpy's f32 ``einsum`` forms it (a matmul may take
    TF32 on a card); ``rays_o`` is the camera position expanded over the
    pixels, with no per-pixel storage."""
    device = grid[0].device
    b = c2w.shape[0]
    host = torch.empty((b, 13), dtype=torch.float32, pin_memory=device.type == "cuda")
    consts = host.numpy()
    consts[:, :9] = c2w[:, :3, :3].transpose(0, 2, 1).reshape(b, 9)  # rotation columns
    consts[:, 9:12] = c2w[:, :3, 3]
    consts[:, 12] = 0.5 * height / np.tan(0.5 * fovy_rad)
    dev = host.to(device, non_blocking=True)
    cols = dev[:, :9].view(b, 3, 1, 1, 3)  # cols[:, c] = c2w[:, :3, c]
    focal = dev[:, 12:]
    gx, gy = grid
    rays_d = ((gx / focal)[:, None, :, None] * cols[:, 0]
              + (gy / focal)[:, :, None, None] * cols[:, 1])
    rays_d.sub_(cols[:, 2])  # the grid's z is -1
    if normalize:
        rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True).clamp_min(1e-12)
    rays_o = dev[:, 9:12].view(b, 1, 1, 3).expand(b, height, width, 3)
    return rays_o, rays_d


def _gl_projection(fovy_rad, aspect, near=0.1, far=1000.0):
    b = fovy_rad.shape[0]
    proj = np.zeros((b, 4, 4), np.float32)
    proj[:, 0, 0] = 1.0 / (np.tan(fovy_rad / 2.0) * aspect)
    proj[:, 1, 1] = 1.0 / np.tan(fovy_rad / 2.0)
    proj[:, 2, 2] = -(far + near) / (far - near)
    proj[:, 2, 3] = -2.0 * far * near / (far - near)
    proj[:, 3, 2] = -1.0
    return proj


def mvp_from_c2w(c2w, fovy_rad, height, width):
    proj = _gl_projection(fovy_rad, width / height)
    w2c = np.linalg.inv(c2w)
    return (proj @ w2c).astype(np.float32)


class RandomCameraSampler:
    """Training-time sampler (reference RandomCameraIterableDataset).  With
    a ``device`` its batches' rays are tensors built there; without one,
    numpy arrays built on the host.  ``ray_builds`` counts the batches of
    each."""

    def __init__(self, cfg: RandomCameraDataModuleConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.device = None if device is None else torch.device(device)
        self.ray_builds = {"device": 0, "host": 0}
        self._grids = {}  # (height, width) -> pixel_grid on self.device
        self.heights = [cfg.height] if isinstance(cfg.height, int) else list(cfg.height)
        self.widths = [cfg.width] if isinstance(cfg.width, int) else list(cfg.width)
        self.batch_sizes = (
            [cfg.batch_size]
            if isinstance(cfg.batch_size, int)
            else list(cfg.batch_size)
        )
        if len(self.heights) == 1:
            self.resolution_milestones = [-1]
        else:
            assert len(self.heights) == len(cfg.resolution_milestones) + 1
            self.resolution_milestones = [-1] + list(cfg.resolution_milestones)
        self.height = self.heights[0]
        self.width = self.widths[0]
        self.batch_size = self.batch_sizes[0]
        self.elevation_range = list(cfg.elevation_range)
        self.azimuth_range = list(cfg.azimuth_range)
        self.camera_distance_range = list(cfg.camera_distance_range)
        self.fovy_range = list(cfg.fovy_range)

    def update_step(self, global_step: int) -> None:
        idx = bisect.bisect_right(self.resolution_milestones, global_step) - 1
        self.height = self.heights[idx]
        self.width = self.widths[idx]
        self.batch_size = self.batch_sizes[idx]
        # progressive widening (reference :129-148)
        r = min(1.0, global_step / (self.cfg.progressive_until + 1))
        self.elevation_range = [
            (1 - r) * self.cfg.eval_elevation_deg + r * self.cfg.elevation_range[0],
            (1 - r) * self.cfg.eval_elevation_deg + r * self.cfg.elevation_range[1],
        ]
        self.azimuth_range = [
            r * self.cfg.azimuth_range[0],
            r * self.cfg.azimuth_range[1],
        ]

    def _rays(self, c2w, fovy):
        h, w = self.height, self.width
        if self.device is None:
            self.ray_builds["host"] += 1
            return rays_from_c2w(c2w, fovy, h, w, self.cfg.rays_d_normalize)
        self.ray_builds["device"] += 1
        if (h, w) not in self._grids:
            self._grids[(h, w)] = pixel_grid(h, w, self.device)
        return device_rays(c2w, fovy, h, w, self.cfg.rays_d_normalize, self._grids[(h, w)])

    def sample(self) -> Dict[str, Any]:
        cfg = self.cfg
        rng = self.rng
        b = self.batch_size

        # elevation: pole-biased uniform or uniform-on-sphere (reference :154-179)
        if rng.random() < 0.5:
            elevation_deg = (
                rng.random(b) * (self.elevation_range[1] - self.elevation_range[0])
                + self.elevation_range[0]
            )
            elevation = np.deg2rad(elevation_deg)
        else:
            lo, hi = np.deg2rad(self.elevation_range)
            elevation = np.arcsin(
                rng.random(b) * (np.sin(hi) - np.sin(lo)) + np.sin(lo)
            )
            elevation_deg = np.rad2deg(elevation)

        # azimuth (reference :183-191)
        if cfg.batch_uniform_azimuth:
            azimuth_deg = (rng.random(b) + np.arange(b)) / b * (
                self.azimuth_range[1] - self.azimuth_range[0]
            ) + self.azimuth_range[0]
        else:
            azimuth_deg = (
                rng.random(b) * (self.azimuth_range[1] - self.azimuth_range[0])
                + self.azimuth_range[0]
            )
        azimuth = np.deg2rad(azimuth_deg)

        camera_distances = (
            rng.random(b)
            * (self.camera_distance_range[1] - self.camera_distance_range[0])
            + self.camera_distance_range[0]
        )
        camera_positions = spherical_to_position(elevation, azimuth, camera_distances)

        center = rng.standard_normal((b, 3)).astype(np.float32) * cfg.center_perturb
        up = (
            np.tile(np.array([0, 0, 1], np.float32), (b, 1))
            + rng.standard_normal((b, 3)).astype(np.float32) * cfg.up_perturb
        )
        camera_positions = camera_positions + (
            rng.random((b, 3)).astype(np.float32) * 2 * cfg.camera_perturb
            - cfg.camera_perturb
        )

        fovy_deg = (
            rng.random(b) * (self.fovy_range[1] - self.fovy_range[0])
            + self.fovy_range[0]
        )
        fovy = np.deg2rad(fovy_deg).astype(np.float32)

        light_distances = (
            rng.random(b)
            * (cfg.light_distance_range[1] - cfg.light_distance_range[0])
            + cfg.light_distance_range[0]
        )
        if cfg.light_sample_strategy == "dreamfusion":
            light_direction = _normalize(
                camera_positions
                + rng.standard_normal((b, 3)).astype(np.float32)
                * cfg.light_position_perturb
            )
            light_positions = light_direction * light_distances[:, None]
        elif cfg.light_sample_strategy == "magic3d":
            local_z = _normalize(camera_positions)
            local_x = _normalize(
                np.stack(
                    [local_z[:, 1], -local_z[:, 0], np.zeros_like(local_z[:, 0])], -1
                )
            )
            local_y = _normalize(np.cross(local_z, local_x))
            rot = np.stack([local_x, local_y, local_z], axis=-1)
            light_az = rng.random(b) * 2 * np.pi - np.pi
            light_el = rng.random(b) * np.pi / 3 + np.pi / 6
            local = spherical_to_position(light_el, light_az, light_distances)
            light_positions = (rot @ local[:, :, None])[:, :, 0]
        else:
            raise ValueError(cfg.light_sample_strategy)

        c2w = build_c2w(camera_positions, center, up)
        with span("data/rays"):
            rays_o, rays_d = self._rays(c2w, fovy)
        mvp = mvp_from_c2w(c2w, fovy, self.height, self.width)

        return {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "mvp_mtx": mvp,
            "camera_positions": camera_positions.astype(np.float32),
            "c2w": c2w,
            "light_positions": light_positions.astype(np.float32),
            "elevation": elevation_deg.astype(np.float32),
            "azimuth": azimuth_deg.astype(np.float32),
            "camera_distances": camera_distances.astype(np.float32),
            "height": self.height,
            "width": self.width,
            "fovy": fovy,
            # global view index within the batch: per-view PRNG keys are
            # fold_in(key, view_index) so stochastic render bits (bg
            # inversion, material aug) are invariant to how the batch is
            # sharded over a device mesh (1 device == N devices bit-for-bit)
            "view_index": np.arange(b, dtype=np.int32),
        }


def fixed_circle_views(
    cfg: RandomCameraDataModuleConfig, split: str = "val"
) -> List[Dict[str, Any]]:
    """Evenly-spaced azimuth circle at eval elevation (reference :360-476)."""
    n = {
        "val": cfg.n_val_views,
        "test": cfg.n_test_views,
    }.get(split, cfg.n_test_views)
    if split == "val":
        azimuth_deg = np.linspace(0, 360.0, n + 1)[:n]
    else:
        azimuth_deg = np.linspace(0, 360.0, n)
    elevation_deg = np.full_like(azimuth_deg, cfg.eval_elevation_deg)
    distances = np.full_like(azimuth_deg, cfg.eval_camera_distance)
    positions = spherical_to_position(
        np.deg2rad(elevation_deg), np.deg2rad(azimuth_deg), distances
    )
    fovy = np.full(n, np.deg2rad(cfg.eval_fovy_deg), np.float32)
    c2w = build_c2w(positions)
    rays_o, rays_d = rays_from_c2w(
        c2w, fovy, cfg.eval_height, cfg.eval_width, cfg.rays_d_normalize
    )
    mvp = mvp_from_c2w(c2w, fovy, cfg.eval_height, cfg.eval_width)
    views = []
    for i in range(n):
        views.append(
            {
                "index": i,
                "rays_o": rays_o[i : i + 1],
                "rays_d": rays_d[i : i + 1],
                "mvp_mtx": mvp[i : i + 1],
                "c2w": c2w[i : i + 1],
                "camera_positions": positions[i : i + 1],
                "light_positions": positions[i : i + 1],
                "elevation": elevation_deg[i : i + 1].astype(np.float32),
                "azimuth": azimuth_deg[i : i + 1].astype(np.float32),
                "camera_distances": distances[i : i + 1].astype(np.float32),
                "height": cfg.eval_height,
                "width": cfg.eval_width,
                "fovy": fovy[i : i + 1],
                "n_all_views": n,
            }
        )
    return views


def random_predict_views(cfg: RandomCameraDataModuleConfig, seed: int = 0):
    """Arbitrary random views for --predict (reference RandomCameraArbiraryDataset)."""
    rng = np.random.default_rng(seed)
    n = cfg.n_predict_views
    azimuth_deg = (
        rng.random(n) * (cfg.predict_azimuth_range[1] - cfg.predict_azimuth_range[0])
        + cfg.predict_azimuth_range[0]
    )
    elevation_deg = (
        rng.random(n)
        * (cfg.predict_elevation_range[1] - cfg.predict_elevation_range[0])
        + cfg.predict_elevation_range[0]
    )
    distances = (
        rng.random(n)
        * (
            cfg.predict_camera_distance_range[1]
            - cfg.predict_camera_distance_range[0]
        )
        + cfg.predict_camera_distance_range[0]
    )
    positions = spherical_to_position(
        np.deg2rad(elevation_deg), np.deg2rad(azimuth_deg), distances
    )
    fovy = np.full(n, np.deg2rad(cfg.eval_fovy_deg), np.float32)
    c2w = build_c2w(positions)
    rays_o, rays_d = rays_from_c2w(
        c2w, fovy, cfg.predict_height, cfg.predict_width, cfg.rays_d_normalize
    )
    mvp = mvp_from_c2w(c2w, fovy, cfg.predict_height, cfg.predict_width)
    views = []
    for i in range(n):
        views.append(
            {
                "index": i,
                "rays_o": rays_o[i : i + 1],
                "rays_d": rays_d[i : i + 1],
                "mvp_mtx": mvp[i : i + 1],
                "c2w": c2w[i : i + 1],
                "camera_positions": positions[i : i + 1],
                "light_positions": positions[i : i + 1],
                "elevation": elevation_deg[i : i + 1].astype(np.float32),
                "azimuth": azimuth_deg[i : i + 1].astype(np.float32),
                "camera_distances": distances[i : i + 1].astype(np.float32),
                "height": cfg.predict_height,
                "width": cfg.predict_width,
                "fovy": fovy[i : i + 1],
                "n_all_views": n,
            }
        )
    return views


@register("random-camera-datamodule")
class RandomCameraDataModule:
    Config = RandomCameraDataModuleConfig

    def __init__(self, cfg=None, seed: int = 0, device=None, **kwargs):
        if cfg is None:
            cfg = RandomCameraDataModuleConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(RandomCameraDataModuleConfig, cfg)
        self.cfg = cfg
        self.train_sampler = RandomCameraSampler(cfg, seed, device)

    def train_batch(self, global_step: int) -> Dict[str, Any]:
        self.train_sampler.update_step(global_step)
        return self.train_sampler.sample()

    def val_views(self):
        return fixed_circle_views(self.cfg, "val")

    def test_views(self):
        return fixed_circle_views(self.cfg, "test")

    def predict_views(self, seed: int = 0):
        return random_predict_views(self.cfg, seed)


@register("random-camera-sugar-datamodule")
class RandomCameraSugarDataModule(RandomCameraDataModule):
    """Alias used by the SuGaR configs (reference data/uncond.py:650)."""


@register("mvdream-random-multiview-camera-datamodule")
@register("random-multiview-camera-datamodule")
class RandomMultiviewCameraDataModule(RandomCameraDataModule):
    """Multi-view batches for MVDream/ImageDream: n_view azimuth-spread
    cameras per scene sample (provided upstream by the mvdream extension;
    here the batch_uniform_azimuth sampler already yields the evenly-spread
    azimuth set, so the random-camera module covers the contract)."""
