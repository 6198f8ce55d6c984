"""Tiny versions of the two cells, small enough to run the whole harness
on the CPU: the cells' own YAMLs with a small field and image, and UNets
and VAEs of two levels (the program's MVDream guidance takes its widths
from ``diffusion.MVDREAM_UNET`` / ``SD_VAE``, which ``mvdream_widths``
patches to the same tiny widths)."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import tempfile

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UNET = dict(block_out_channels=[32, 64], attention_head_dim=[1, 2], norm_num_groups=8,
            down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"])
VAE = dict(block_out_channels=[16, 32], norm_num_groups=8)


def cell(name: str, f32: bool = True):
    """The cell ``name`` at tiny sizes (its limits kept)."""
    c = copy.deepcopy(harness.load_cell(name))
    c["config"]["name"] = "tiny-" + c["config"]["name"]
    c["config"]["unet"].update(UNET)
    c["config"]["vae"].update(VAE)
    extra = ["system.geometry.init_num_pts=256", "system.geometry.max_num=1000"]
    if c["config"]["kind"] == "sd":
        extra += ["data.width=64", "data.height=64", "data.batch_size=2"]
        if f32:
            extra.append("system.guidance.half_precision_weights=false")
    else:
        extra += ["data.width=[64,64]", "data.height=[64,64]", "system.guidance.image_size=64"]
        c["config"]["image_size"] = 64
    c["traffic"]["overrides"] = c["traffic"]["overrides"] + extra
    return c


@contextlib.contextmanager
def mvdream_widths():
    """The program's MVDream guidance at the tiny widths."""
    import torch

    from threestudio_3dgs_tpu_torch import diffusion

    saved = diffusion.MVDREAM_UNET, diffusion.SD_VAE
    diffusion.MVDREAM_UNET = dataclasses.replace(
        saved[0], block_out_channels=tuple(UNET["block_out_channels"]),
        attention_head_dim=tuple(UNET["attention_head_dim"]), norm_groups=8,
        down_block_types=tuple(UNET["down_block_types"]),
        up_block_types=tuple(UNET["up_block_types"]), dtype=torch.float32)
    diffusion.SD_VAE = dataclasses.replace(saved[1], block_out_channels=tuple(VAE["block_out_channels"]),
                                           norm_groups=8)
    try:
        yield
    finally:
        diffusion.MVDREAM_UNET, diffusion.SD_VAE = saved


def run(c, seed=20251018, seconds=0.5, **kw):
    """The harness on the CPU, its weights and run directory in a fresh
    temporary directory; the result with its compared numbers."""
    ctx = mvdream_widths() if c["config"]["kind"] == "mvdream" else contextlib.nullcontext()
    with ctx, tempfile.TemporaryDirectory() as work:
        return harness.run(c["name"], seed, seconds, False, root=ROOT, device="cpu",
                           require_card=False, cell=c, log=lambda s: None, work_dir=work, **kw)
