"""Image-grid and video saving (port of the JAX package's
``utils/saving.py``).

PNGs are written by a small encoder on the standard library (zlib, struct)
and numpy: 8-bit RGB or RGBA, no filtering, one IDAT chunk.  The pixels
equal those the JAX package writes through imageio.  ``decode_png`` reads
any non-interlaced PNG of bit depth 8 or 16 (gray, gray + alpha, RGB,
RGBA; palette at depth 8, with its tRNS alpha) and all five scanline
filters, for the image-to-3D loader (the card's machine has neither cv2
nor PIL).  The video of the test
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


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines -> (H, stride) bytes.  None, Sub
    and Up run as numpy row operations; Average and Paeth, whose bytes
    depend on the ones just reconstructed, byte by byte."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            pad = -stride % bpp
            cols = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            row = (np.cumsum(cols.astype(np.int64), axis=0) % 256).astype(np.uint8).reshape(-1)
            row = row[:stride]
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):
            cur, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:  # Average
                    cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
                else:  # Paeth
                    ul = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(left, up[i], ul)) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has unknown filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 (depth 8) or uint16 (depth 16), the
    samples in the file's order: C = 1 gray, 2 gray + alpha, 3 RGB, 4 RGBA;
    a palette image becomes RGB, or RGBA where it has a tRNS chunk.  Raises
    on interlaced files, on depths other than 8 and 16, and on a tRNS
    colour key of a gray or RGB image."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, header, palette, trns = len(_PNG_SIGNATURE), [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if interlace != 0:
        raise ValueError("interlaced PNGs are not supported")
    if color not in _PNG_CHANNELS or depth not in (8, 16) or (color == 3 and depth != 8):
        raise ValueError(f"unsupported PNG: depth {depth}, color type {color}")
    channels, nbytes = _PNG_CHANNELS[color], depth // 8
    stride = w * channels * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError("truncated PNG image data")
    rows = _unfilter(raw[: h * (1 + stride)].reshape(h, 1 + stride), channels * nbytes)
    if nbytes == 1:
        img = rows.reshape(h, w, channels)
    else:  # big-endian samples
        img = rows.reshape(h, w, channels, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        if trns is None:
            return palette[idx]
        alpha = np.full(256, 255, np.uint8)
        alpha[: trns.size] = trns
        return np.concatenate([palette[idx], alpha[idx][..., None]], axis=-1)
    if trns is not None:
        raise ValueError("tRNS colour keys of gray / RGB PNGs are not supported")
    return img


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
