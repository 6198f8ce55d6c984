"""Single reference-image data module for image-to-3D (port of the JAX
package's ``data/image.py``): a fixed default camera with the RGBA image,
its mask and optional depth / normal maps, resolution milestones, and an
embedded random-camera sampler whose batch rides along as
``batch["random_camera"]`` (its rays built on the module's ``device``
where it is given one); val / test views are the random-camera
config's fixed circles.  With an empty ``image_path`` a grey synthetic
image stands in.

The JAX package reads the images with ``cv2.imread(IMREAD_UNCHANGED)`` and
shrinks them with ``cv2.resize(INTER_AREA)``; the card's machine has no
cv2, so the port has both in numpy: :func:`read_image_unchanged` (cv2's
channels: 2-D gray, BGR, BGRA, gray + alpha as BGRA, palette as BGR or
BGRA; 8 or 16 bits kept) on ``utils/saving.py`` ``decode_png``, and
:func:`resize_area`, cv2's INTER_AREA on uint8 and uint16: at integer
shrink factors the block mean (a 2x2 block's sum + 2 >> 2, larger blocks
rounded half to even), at other shrink factors cv2's area weights summed
in f32, and when enlarging cv2's INTER_AREA coefficients (nearest at
integer factors) in its 11-bit fixed point for uint8, each rounded to the
integer type before the loader's / 255, as cv2 returns it."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..utils.config import parse_structured
from ..utils.registry import register
from ..utils.saving import decode_png
from .uncond import (
    RandomCameraDataModuleConfig,
    RandomCameraSampler,
    build_c2w,
    fixed_circle_views,
    mvp_from_c2w,
    rays_from_c2w,
    spherical_to_position,
)


@dataclasses.dataclass
class SingleImageDataModuleConfig:
    height: Any = 96
    width: Any = 96
    resolution_milestones: List[int] = dataclasses.field(default_factory=list)
    default_elevation_deg: float = 0.0
    default_azimuth_deg: float = -180.0
    default_camera_distance: float = 1.2
    default_fovy_deg: float = 60.0
    image_path: str = ""
    use_random_camera: bool = True
    random_camera: dict = dataclasses.field(default_factory=dict)
    rays_noise_scale: float = 2e-3
    batch_size: int = 1
    requires_depth: bool = False
    requires_normal: bool = False
    rays_d_normalize: bool = True


# ---------------------------------------------------------------------------
# cv2's imread and INTER_AREA resize, in numpy
# ---------------------------------------------------------------------------


def read_image_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for a PNG: (H, W) gray,
    (H, W, 3) BGR (RGB and palette images), (H, W, 4) BGRA (RGBA, gray +
    alpha as B = G = R = gray, palette with tRNS); uint8 or uint16 as the
    file's depth.  Raises FileNotFoundError where cv2 returns None."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(path) from e
    img = decode_png(data)
    c = img.shape[-1]
    if c == 1:
        return img[..., 0]
    if c == 2:
        gray, alpha = img[..., :1], img[..., 1:]
        return np.concatenate([gray, gray, gray, alpha], axis=-1)
    return np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    """cv2's saturate_cast from float: round half to even, clamp."""
    info = np.iinfo(dtype)
    return np.clip(np.rint(x), info.min, info.max).astype(dtype)


def _area_table(src: int, dst: int, scale: float):
    """cv2's computeResizeAreaTab: per destination index, its (source
    index, weight) entries in order, as (slots, dst) arrays (weight 0 where
    an index has fewer entries)."""
    entries: List[List[tuple]] = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            row.append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        entries.append(row)
    slots = max(len(r) for r in entries)
    idx = np.zeros((slots, dst), np.int64)
    w = np.zeros((slots, dst), np.float32)
    has = np.zeros((slots, dst), bool)
    for dx, row in enumerate(entries):
        for s, (si, a) in enumerate(row):
            idx[s, dx], w[s, dx], has[s, dx] = si, a, True
    return idx, w, has


def _resize_area_general(x: np.ndarray, dw: int, dh: int, sx: float, sy: float) -> np.ndarray:
    """cv2's resizeArea: area weights per source row and column, the sums
    in f32 in the table's order."""
    xi, xw, xh = _area_table(x.shape[1], dw, sx)
    yi, yw, yh = _area_table(x.shape[0], dh, sy)
    xf = x.astype(np.float32)
    buf = np.zeros((x.shape[0], dw, x.shape[2]), np.float32)
    for s in range(xi.shape[0]):
        cols = np.nonzero(xh[s])[0]
        buf[:, cols] += xf[:, xi[s, cols]] * xw[s, cols][None, :, None]
    out = np.zeros((dh, dw, x.shape[2]), np.float32)
    for s in range(yi.shape[0]):
        rows = np.nonzero(yh[s])[0]
        out[rows] += yw[s, rows][:, None, None] * buf[yi[s, rows]]
    return _saturate(out, x.dtype)


def _area_coeffs(src: int, dst: int, scale: float, inv_scale: float):
    """cv2's INTER_AREA coefficients when not shrinking on both axes: the
    source index and the weight of the next one, per destination index."""
    idx = np.zeros(dst, np.int64)
    frac = np.zeros(dst, np.float32)
    for d in range(dst):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.float32(np.floor(f)))
        if s >= src - 1:
            s, f = src - 1, np.float32(0.0)
        idx[d], frac[d] = s, f
    return idx, frac


def _resize_area_linear(x: np.ndarray, dw: int, dh: int, sx: float, sy: float,
                        inv_x: float, inv_y: float) -> np.ndarray:
    """cv2's linear pass with INTER_AREA's coefficients: uint8 in its 11-bit
    fixed point, uint16 in f32."""
    h, w = x.shape[:2]
    xs, fx = _area_coeffs(w, dw, sx, inv_x)
    ys, fy = _area_coeffs(h, dh, sy, inv_y)
    x1, y1 = np.minimum(xs + 1, w - 1), np.minimum(ys + 1, h - 1)
    if x.dtype == np.uint8:
        ax = np.stack([_saturate((np.float32(1) - fx) * np.float32(2048), np.int16),
                       _saturate(fx * np.float32(2048), np.int16)]).astype(np.int64)
        ay = np.stack([_saturate((np.float32(1) - fy) * np.float32(2048), np.int16),
                       _saturate(fy * np.float32(2048), np.int16)]).astype(np.int64)
        xi = x.astype(np.int64)
        hor = xi[:, xs] * ax[0][None, :, None] + xi[:, x1] * ax[1][None, :, None]
        s0, s1 = hor[ys] >> 4, hor[y1] >> 4
        b0, b1 = ay[0][:, None, None], ay[1][:, None, None]
        return ((((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2).astype(np.uint8)
    xf = x.astype(np.float32)
    hor = xf[:, xs] * (np.float32(1) - fx)[None, :, None] + xf[:, x1] * fx[None, :, None]
    out = hor[ys] * (np.float32(1) - fy)[:, None, None] + hor[y1] * fy[:, None, None]
    return _saturate(out, x.dtype)


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    for a uint8 or uint16 (H, W) or (H, W, C) image."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"resize_area takes uint8 or uint16, got {img.dtype}")
    x = img[..., None] if img.ndim == 2 else img
    h, w, cn = x.shape
    if (w, h) == (width, height):
        return img.copy()
    inv_x, inv_y = width / w, height / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
            blocks = x[: height * iy, : width * ix].astype(np.int64).reshape(
                height, iy, width, ix, cn).sum(axis=(1, 3))
            if ix == 2 and iy == 2 and cn in (1, 3, 4):
                out = ((blocks + 2) >> 2).astype(x.dtype)
            else:
                out = _saturate(blocks.astype(np.float32) * np.float32(1.0 / (ix * iy)), x.dtype)
        else:
            out = _resize_area_general(x, width, height, sx, sy)
    else:
        out = _resize_area_linear(x, width, height, sx, sy, inv_x, inv_y)
    return out[..., 0] if img.ndim == 2 else out


def _load_rgba(path: str, width: int, height: int) -> np.ndarray:
    """(height, width, 4) f32 RGBA in [0, 1]: the JAX loader's steps, with
    the resize rounded to the file's integer type before the / 255."""
    img = read_image_unchanged(path)
    if img.ndim == 3 and img.shape[-1] == 4:
        rgba = img[..., [2, 1, 0, 3]]
    elif img.ndim == 3 and img.shape[-1] == 3:
        rgba = np.concatenate([img[..., ::-1], np.full_like(img[..., :1], 255)], axis=-1)
    else:
        # cv2.cvtColor(BGR2RGB) refuses a one-channel image in the JAX loader
        raise ValueError(f"{path}: a gray image without alpha is not an RGB(A) reference")
    return resize_area(rgba, width, height).astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# The data module
# ---------------------------------------------------------------------------


@register("single-image-gs-datamodule")
@register("single-image-datamodule")
class SingleImageDataModule:
    Config = SingleImageDataModuleConfig

    def __init__(self, cfg=None, seed: int = 0, device=None, **kwargs):
        if cfg is None:
            cfg = SingleImageDataModuleConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(SingleImageDataModuleConfig, cfg)
        self.cfg = cfg
        self.random_camera_cfg = parse_structured(RandomCameraDataModuleConfig,
                                                  dict(cfg.random_camera))
        self.random_sampler = (RandomCameraSampler(self.random_camera_cfg, seed, device)
                               if cfg.use_random_camera else None)
        self.heights = [cfg.height] if isinstance(cfg.height, int) else list(cfg.height)
        self.widths = [cfg.width] if isinstance(cfg.width, int) else list(cfg.width)
        if len(self.heights) == 1:
            self.resolution_milestones = [-1]
        else:
            self.resolution_milestones = [-1] + list(cfg.resolution_milestones)

        elevation = np.deg2rad(np.array([cfg.default_elevation_deg], np.float32))
        azimuth = np.deg2rad(np.array([cfg.default_azimuth_deg], np.float32))
        distance = np.array([cfg.default_camera_distance], np.float32)
        self.camera_position = spherical_to_position(elevation, azimuth, distance)
        self.c2w = build_c2w(self.camera_position)
        self.fovy = np.deg2rad(np.array([cfg.default_fovy_deg], np.float32))
        self.elevation_deg = np.array([cfg.default_elevation_deg], np.float32)
        self.azimuth_deg = np.array([cfg.default_azimuth_deg], np.float32)
        self.distance = distance

        self._size_idx = -1
        self._set_resolution(0)

    def _set_resolution(self, global_step: int) -> None:
        idx = bisect.bisect_right(self.resolution_milestones, global_step) - 1
        if idx == self._size_idx:
            return
        self._size_idx = idx
        self.height, self.width = self.heights[idx], self.widths[idx]
        self.rays_o, self.rays_d = rays_from_c2w(self.c2w, self.fovy, self.height, self.width,
                                                 self.cfg.rays_d_normalize)
        self.mvp = mvp_from_c2w(self.c2w, self.fovy, self.height, self.width)
        self._load_images()

    def _load_images(self) -> None:
        cfg = self.cfg
        self.depth = self.normal = None
        if not cfg.image_path:
            # synthetic fallback (tests and smoke runs without assets)
            self.rgb = np.full((1, self.height, self.width, 3), 0.5, np.float32)
            self.mask = np.ones((1, self.height, self.width, 1), np.float32)
            return
        rgba = _load_rgba(cfg.image_path, self.width, self.height)
        self.rgb = rgba[None, ..., :3]
        self.mask = (rgba[None, ..., 3:] > 0.5).astype(np.float32)
        if cfg.requires_depth:
            depth = resize_area(read_image_unchanged(cfg.image_path.replace("_rgba.png",
                                                                            "_depth.png")),
                                self.width, self.height)
            if depth.ndim == 3:
                depth = depth[..., 0]
            self.depth = (depth.astype(np.float32) / 255.0)[None, ..., None]
        if cfg.requires_normal:
            normal = resize_area(read_image_unchanged(cfg.image_path.replace("_rgba.png",
                                                                             "_normal.png")),
                                 self.width, self.height)
            self.normal = (normal.astype(np.float32) / 255.0)[None]

    def train_batch(self, global_step: int) -> Dict[str, Any]:
        self._set_resolution(global_step)
        batch = {
            "rays_o": self.rays_o,
            "rays_d": self.rays_d,
            "mvp_mtx": self.mvp,
            "camera_positions": self.camera_position,
            "c2w": self.c2w,
            "light_positions": self.camera_position,
            "elevation": self.elevation_deg,
            "azimuth": self.azimuth_deg,
            "camera_distances": self.distance,
            "height": self.height,
            "width": self.width,
            "fovy": self.fovy,
            "rgb": self.rgb,
            "mask": self.mask,
            "ref_depth": self.depth,
            "ref_normal": self.normal,
        }
        if self.random_sampler is not None:
            self.random_sampler.update_step(global_step)
            batch["random_camera"] = self.random_sampler.sample()
        return batch

    def val_views(self):
        return fixed_circle_views(self.random_camera_cfg, "val")

    def test_views(self):
        return fixed_circle_views(self.random_camera_cfg, "test")
