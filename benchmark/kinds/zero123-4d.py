"""Kind ``zero123-4d``: video-to-4D with the temporal Stable Zero123
guidance (``gaussian-splatting-4dgen-system`` in its ``motion`` stage,
``temporal-stable-zero123-guidance``).

  * weights, in draw order: the Zero123 UNet (``unet/``: 8 input
    channels, 1x1-convolution projections, a context of one 768-wide
    token), the SD VAE's encoder and quant_conv (``vae/``), the CLIP
    ViT-L/14 image tower (``image_encoder/``, ``pytorch_model.bin``) and
    ``cc_projection`` (``clip_camera_projection/``, ``proj``: 772 -> 768);
  * inputs: the traffic's ``data.video_length`` seeded RGBA frames
    ``frames/<i:03>_rgba.png`` at the data's first size: a striped,
    speckled ellipse that moves, turns and changes its axes over the
    clip, on a transparent background;
  * the reference step: ``reference.video4d.VideoTo4D``;
  * model FLOPs: the UNet's forward on the CFG batch (2 x the guided views
    of ``batch["random_camera"]``) at ``cond_image_size`` / 8 with a
    context of one token, and the VAE encoder's forward and its backward
    to the input on the guided views at ``cond_image_size``
    (``costs.py``); every product at the bf16 peak but conv_out and
    quant_conv (float32 in the program), at the convolutions' peak.  Not
    counted: the renders, the timed evaluations of the field, and the CLIP
    embeddings and ``c_concat``, computed once a run."""

import os
import struct
import zlib

import numpy as np
import yaml

from benchmark import costs
from benchmark.reference import clip_vision, diffusion, video4d


def weight_files(config):
    ccp = config["clip_camera_projection"]
    return [
        {"name": "unet", "config": config["unet"], "shapes": diffusion.unet_shapes(config["unet"])},
        {"name": "vae", "config": config["vae"],
         "shapes": diffusion.vae_encoder_shapes(config["vae"])},
        {"name": "image_encoder", "config": config["image_encoder"], "file": "pytorch_model.bin",
         "shapes": clip_vision.shapes(config["image_encoder"])},
        {"name": "clip_camera_projection", "config": ccp,
         "shapes": {"proj.weight": (ccp["out_channel"], ccp["in_channel"]),
                    "proj.bias": (ccp["out_channel"],)}},
    ]


Reference = video4d.VideoTo4D


def _png(path, rgba):
    """An 8-bit RGBA PNG of (H, W, 4) uint8, rows unfiltered."""
    h, w, _ = rgba.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def frames(seed, n, size):
    """(n, size, size, 4) uint8: the clip's frames."""
    rng = np.random.default_rng(seed)
    colours = rng.uniform(0.1, 0.9, (3, 3))
    phase = rng.uniform(0, 2 * np.pi, 4)
    freq = rng.uniform(3.0, 7.0)
    speckle = rng.uniform(-0.08, 0.08, (size, size, 3))
    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    out = []
    for i in range(n):
        t = i / max(n - 1, 1)
        cx = 0.5 + 0.15 * np.sin(2 * np.pi * t + phase[0])
        cy = 0.5 + 0.12 * np.cos(2 * np.pi * t + phase[1])
        ax = 0.24 + 0.06 * np.sin(2 * np.pi * t + phase[2])  # the axes change: it deforms
        ay = 0.18 + 0.05 * np.cos(2 * np.pi * t + phase[3])
        angle = phase[0] + np.pi / 3 * t
        u = ((xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)) / ax
        v = (-(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)) / ay
        inside = u * u + v * v <= 1.0
        stripes = 0.5 + 0.5 * np.sin(freq * np.pi * u)[..., None]
        rgb = colours[0] + (colours[1] - colours[0]) * stripes
        rgb = np.where((v > 0.3)[..., None], colours[2], rgb) + speckle
        alpha = np.where(inside, 1.0, 0.0)[..., None]
        rgba = np.concatenate([np.clip(rgb, 0, 1), alpha], axis=-1)
        out.append(np.round(rgba * 255).astype(np.uint8))
    return np.stack(out)


def inputs(cell, seed, run_dir):
    from benchmark import compare

    root = os.path.dirname(cell["dir"])  # the checkout of the cell's benchmark directory
    with open(os.path.join(root, cell["traffic"]["yaml"])) as f:
        cfg = compare.apply_overrides(yaml.safe_load(f), list(cell["traffic"]["overrides"]))
    data = video4d.resolve(cfg)["data"]
    size = data["height"][0] if isinstance(data["height"], list) else data["height"]
    directory = os.path.join(run_dir, "frames")
    os.makedirs(directory)
    for i, rgba in enumerate(frames(seed, int(data["video_length"]), int(size))):
        _png(os.path.join(directory, f"{i:03}_rgba.png"), rgba)
    return [f"data.video_frames_dir={directory}"]


def model_seconds(config, ctx, flags):
    conv_peak = costs.PEAK_TF32 if flags["cudnn_tf32"] else costs.PEAK_F32
    b = len(ctx["batch"]["random_camera"]["c2w"])
    size = int(config["cond_image_size"])
    unet = costs.unet_flops(config["unet"], 2 * b, size // 8, size // 8, 1)
    fwd = costs.vae_encoder_flops(config["vae"], b, size, size)
    vae = {k: v + costs.vae_backward_to_input(fwd)[k] for k, v in fwd.items()}
    t = (sum(v for k, v in unet.items() if k != "conv_out") + vae["conv"] + vae["dense"]
         + vae["attn"]) / costs.PEAK_BF16
    return t + (unet["conv_out"] + vae["conv_out"]) / conv_peak
