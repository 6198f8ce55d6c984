"""Image-grid and video saving (port of the JAX package's
``utils/saving.py``).

PNGs are written by a small encoder on the standard library (zlib, struct)
and numpy: 8-bit RGB or RGBA, no filtering, one IDAT chunk.  The pixels
equal those the JAX package writes through imageio.  The video of the test
frames needs imageio, which the card's machine does not have: without it
``save_img_sequence`` writes no video, says so and returns None (the PNG
frames are the product).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {3: 2, 4: 6}  # channels -> RGB, RGBA


def to_uint8(img: np.ndarray, data_range=(0, 1)) -> np.ndarray:
    lo, hi = data_range
    img = (np.asarray(img, np.float32) - lo) / max(hi - lo, 1e-8)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"encode_png takes (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    # each scanline starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The inverse of encode_png, for the PNGs it writes only (8-bit RGB or
    RGBA, scanlines unfiltered); raises on anything else."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _PNG_COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"unsupported PNG: depth {depth}, color type {color}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError("filtered PNG scanlines are not supported")
    return raw[:, 1:].reshape(h, w, channels)


def save_image_grid(path: str, images: List[np.ndarray], data_range=(0, 1)) -> None:
    """Horizontally concatenate (H, W, C) images and save as png."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rows = []
    for img in images:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        rows.append(to_uint8(img, data_range))
    with open(path, "wb") as f:
        f.write(encode_png(np.concatenate(rows, axis=1)))


def save_img_sequence(
    out_path: str, img_dir: str, pattern: str = r"(\d+)\.png", fps: int = 30
) -> Optional[str]:
    """Collect numbered frames from img_dir into an mp4 (or a gif where
    imageio has no mp4 writer).  None without frames or without imageio."""
    rx = re.compile(pattern)
    frames = []
    for name in os.listdir(img_dir):
        m = rx.match(name)
        if m:
            frames.append((int(m.group(1)), os.path.join(img_dir, name)))
    if not frames:
        return None
    try:
        import imageio.v2 as imageio
    except ImportError:
        print(f"[saving] imageio is not installed: no video of the {len(frames)} frames "
              f"in {img_dir}", flush=True)
        return None
    frames.sort()
    imgs = [imageio.imread(f) for _, f in frames]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    try:
        imageio.mimwrite(out_path, imgs, fps=fps)
    except ValueError:  # no mp4 backend (imageio-ffmpeg / pyav)
        out_path = os.path.splitext(out_path)[0] + ".gif"
        imageio.mimwrite(out_path, imgs, duration=1.0 / fps)
    return out_path
