"""The port's image-to-3D data path (threestudio_3dgs_tpu_torch.data.image
and utils.saving.decode_png) against PIL, cv2 and the JAX package on the
CPU: the PNG decoder on every scanline filter, bit depth and colour type;
cv2's imread(IMREAD_UNCHANGED) and resize(INTER_AREA); the RGBA loader and
the single-image data module's batches (the reference view, its rays and
MVP, the image, mask, depth and normal maps at each resolution milestone,
the random-camera batch riding along, the eval circles)."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from threestudio_3dgs_tpu.data import image as jimage

from threestudio_3dgs_tpu_torch.data import image as pimage
from threestudio_3dgs_tpu_torch.utils.saving import decode_png
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_filtered(samples: np.ndarray, color: int, filters, palette=None, trns=None) -> bytes:
    """A PNG of ``samples`` (H, W, C) uint8 / uint16 whose row y is written
    with filter ``filters[y % len(filters)]``: an encoder independent of
    the one under test, to reach every filter the decoder must undo."""
    h, w, c = samples.shape
    depth = 16 if samples.dtype == np.uint16 else 8
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    else:
        rows = samples.reshape(h, w * c)
    bpp = c * depth // 8
    rows = rows.astype(np.int64)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        cur, kind = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2, 4: _paeth(left, prev, upleft)}[kind]
        out.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    body = _chunk(b"IHDR", header)
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(np.stack(out).tobytes()))
            + _chunk(b"IEND", b""))


def pil_array(path) -> np.ndarray:
    """PIL's samples of a PNG as (H, W, C): 16-bit gray through mode I."""
    im = Image.open(path)
    arr = np.asarray(im)
    if im.mode == "P":
        im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        arr = np.asarray(im)
    if im.mode.startswith("I"):
        arr = arr.astype(np.uint16)
    return arr if arr.ndim == 3 else arr[..., None]


COLOR_TYPES = {"gray": (0, 1), "gray_alpha": (4, 2), "rgb": (2, 3), "rgba": (6, 4)}
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4]}


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color", sorted(COLOR_TYPES))
def test_decode_png_matches_pil(tmp_path, color, depth, filt):
    """Every scanline filter (None, Sub, Up, Average, Paeth, and all five in
    turn) at bit depths 8 and 16 and colour types gray, gray + alpha, RGB
    and RGBA: the decoded samples equal PIL's (16-bit gray and RGB(A):
    equal to the written samples, which PIL reads only as 8-bit or I)."""
    code, c = COLOR_TYPES[color]
    rng = np.random.default_rng(zlib.crc32(f"{color}-{depth}-{filt}".encode()))
    dtype = np.uint16 if depth == 16 else np.uint8
    samples = rng.integers(0, 2**depth, size=(13, 17, c)).astype(dtype)
    data = encode_filtered(samples, code, FILTERS[filt])
    got = decode_png(data)
    assert got.dtype == dtype and got.shape == samples.shape
    np.testing.assert_array_equal(got, samples)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    if depth == 8 or color == "gray":
        np.testing.assert_array_equal(got, pil_array(path))


@pytest.mark.parametrize("trns", [False, True], ids=["palette", "palette_trns"])
def test_decode_png_palette_matches_pil(tmp_path, trns):
    """A palette image (depth 8, Paeth and Sub rows): RGB, or RGBA with its
    tRNS alphas (fewer than the palette's entries), equal to PIL's."""
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, size=(40, 3))
    idx = rng.integers(0, 40, size=(11, 9, 1)).astype(np.uint8)
    alphas = rng.integers(0, 256, size=25) if trns else None
    path = tmp_path / "p.png"
    path.write_bytes(encode_filtered(idx, 3, [4, 1], palette=palette, trns=alphas))
    got = decode_png(path.read_bytes())
    assert got.shape == (11, 9, 4 if trns else 3)
    np.testing.assert_array_equal(got, pil_array(path))


def test_decode_png_refuses_interlaced():
    data = bytearray(encode_filtered(np.zeros((4, 4, 3), np.uint8), 2, [0]))
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1  # interlace method: Adam7
    data[16:29] = ihdr
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P_trns", "I16"])
def test_read_image_unchanged_matches_cv2(tmp_path, mode):
    """cv2.imread(IMREAD_UNCHANGED)'s array for PIL-written PNGs of each
    mode (cv2 5.0 here): 2-D gray, BGR, BGRA, gray + alpha as BGRA,
    palette as BGR (BGRA with tRNS), 16-bit gray as uint16."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (21, 30, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (21, 30), dtype=np.uint8)
    path = str(tmp_path / "m.png")
    if mode == "I16":
        Image.fromarray(rng.integers(0, 65536, (21, 30), dtype=np.uint16)).save(path)
    elif mode == "LA":
        Image.fromarray(np.stack([gray, 255 - gray], -1), "LA").save(path)
    elif mode.startswith("P"):
        kw = {"transparency": bytes(range(0, 256, 3))} if mode == "P_trns" else {}
        Image.fromarray(rgb).convert("P").save(path, **kw)
    elif mode == "L":
        Image.fromarray(gray).save(path)
    else:
        Image.fromarray(rng.integers(0, 256, (21, 30, len(mode)), dtype=np.uint8), mode).save(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = pimage.read_image_unchanged(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (source (h, w, c), destination (w, h)): integer shrink factors (2 with a
# 2x2 block's rounding, 4, and 3 x 2), non-integer shrinks, integer and
# non-integer enlargements, and one axis shrunk while the other grows
INTEGER = [((64, 64, 4), (32, 32)), ((64, 64, 3), (16, 16)), ((60, 48, 1), (16, 30)),
           ((64, 64, 2), (32, 32)), ((16, 16, 4), (64, 64)), ((20, 12, 4), (24, 40))]
OTHER = [((64, 64, 4), (40, 40)), ((60, 48, 1), (37, 53)), ((64, 64, 3), (100, 90)),
         ((64, 64, 4), (30, 120)), ((64, 64, 4), (63, 65)), ((48, 48, 4), (32, 32))]


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("shape,size", INTEGER + OTHER,
                         ids=[f"{s}->{d}" for s, d in INTEGER + OTHER])
def test_resize_area_matches_cv2(shape, size, dtype):
    """cv2.resize(INTER_AREA), the JAX loader's resize, on random images:
    exact at integer factors (the block means, nearest when enlarging), and
    within one unit of the integer type (1/255 after the loader's / 255)
    elsewhere; with cv2 5.0 here every case listed is in fact exact."""
    h, w, c = shape
    rng = np.random.default_rng(h * w + c)
    top = 256 if dtype == "uint8" else 65536
    img = rng.integers(0, top, shape if c > 1 else (h, w)).astype(dtype)
    want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    got = pimage.resize_area(img, *size)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64)).max()
    assert diff <= (0 if (shape, size) in INTEGER else 1)


def write_rgba(path, size=64, seed=0):
    """A disc on transparency, as an RGBA PNG through PIL."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1) * 2 - 1
    alpha = ((xx**2 + yy**2) < 0.5).astype(np.uint8) * 255
    rgb = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1), "RGBA").save(path)


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
@pytest.mark.parametrize("size", [32, 48, 64, 100])
def test_load_rgba_matches_jax(tmp_path, mode, size):
    """The RGBA loader against the JAX package's ``_load_rgba`` (cv2) on the
    same file: equal, at shrink, non-integer and enlarging sizes."""
    path = str(tmp_path / "ref_rgba.png")
    write_rgba(path)
    if mode == "RGB":
        Image.open(path).convert("RGB").save(path)
    want = jimage._load_rgba(path, size, size)
    got = pimage._load_rgba(path, size, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def batches_equal(got, want):
    assert sorted(got) == sorted(k for k in want), (sorted(got), sorted(want))
    for k, v in want.items():
        if isinstance(v, dict):
            batches_equal(got[k], v)
        elif v is None or isinstance(v, (int, float, str)):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.fixture()
def reference(tmp_path):
    """An RGBA reference with 16-bit depth and 8-bit RGB normal maps."""
    path = str(tmp_path / "thing_rgba.png")
    write_rgba(path, size=64, seed=1)
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 65536, (64, 64), dtype=np.uint16)).save(
        path.replace("_rgba.png", "_depth.png"))
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        path.replace("_rgba.png", "_normal.png"))
    return path


RANDOM_CAMERA = {"batch_size": 2, "height": 16, "width": 16, "eval_height": 24,
                 "eval_width": 24, "n_val_views": 3, "n_test_views": 4,
                 "elevation_range": [-10, 80], "camera_distance_range": [3.8, 3.8],
                 "fovy_range": [20.0, 20.0], "batch_uniform_azimuth": False}


@pytest.mark.parametrize("maps", [False, True], ids=["rgba", "depth_normal"])
@pytest.mark.parametrize("image", [True, False], ids=["png", "synthetic"])
def test_datamodule_batches_match_jax(reference, maps, image):
    """Both packages' single-image data modules, one seed: the train batches
    at steps 0, 2 and 3 (resolution milestones [2, 3]: 16^2, 24^2, 32^2),
    each with its random-camera batch, then the val and test circles.  With
    an empty image_path both fall back to the grey image; with maps on,
    the depth (16-bit, / 255 as cv2 reads it) and normal maps ride along."""
    cfg = dict(height=[16, 24, 32], width=[16, 24, 32], resolution_milestones=[2, 3],
               default_elevation_deg=5.0, default_azimuth_deg=0.0,
               default_camera_distance=3.8, default_fovy_deg=20.0,
               image_path=reference if image else "", requires_depth=maps,
               requires_normal=maps, random_camera=RANDOM_CAMERA)
    jd = jimage.SingleImageDataModule(dict(cfg), seed=3)
    pd = pfind("single-image-gs-datamodule")(dict(cfg), seed=3)
    assert pfind("single-image-datamodule") is type(pd)
    for step in (0, 1, 2, 3, 4):
        want, got = jd.train_batch(step), pd.train_batch(step)
        batches_equal(got, want)
        assert got["height"] == [16, 16, 24, 32, 32][step]
        if maps and image:
            assert got["ref_depth"].shape == (1, got["height"], got["height"], 1)
            assert got["ref_depth"].max() > 1.0  # 16-bit depths / 255
    for split in ("val_views", "test_views"):
        want, got = getattr(jd, split)(), getattr(pd, split)()
        assert len(got) == len(want) == (3 if split == "val_views" else 4)
        for g, w in zip(got, want):
            batches_equal(g, w)


def test_missing_reference_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pimage._load_rgba(str(tmp_path / "none.png"), 8, 8)
    assert os.path.exists(tmp_path)
