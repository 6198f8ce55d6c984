"""AutoencoderKL (the SD VAE) encoder and decoder, PyTorch, NCHW (port of
the JAX package's ``diffusion/vae.py``).

``VAEEncoder`` holds diffusers' ``encoder.*`` and ``quant_conv.*`` keys,
``VAEDecoder`` the ``post_quant_conv.*`` and ``decoder.*`` keys, so each
loads its half of a diffusers ``AutoencoderKL`` state dict strictly
(``vae_half``).  Compute types follow the JAX package, as in ``unet.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.tracing import span
from .unet import Conv2d, GroupNorm, Linear, ResnetBlock, UNetBlock, Upsample


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32


SD_VAE = AutoencoderKLConfig()


class VAEAttention(nn.Module):
    """Single-head self-attention over the spatial positions with biased
    q/k/v (the VAE's mid-block ``Attention``): a plain matmul with an f32
    softmax, residual add."""

    def __init__(self, channels, groups, dtype):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels, compute_dtype=dtype)
        self.to_k = Linear(channels, channels, compute_dtype=dtype)
        self.to_v = Linear(channels, channels, compute_dtype=dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, compute_dtype=dtype),
                                     nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        # the JAX package scales by an f32 array, so bf16 logits become f32 here
        scale = 1.0 / torch.sqrt(torch.tensor(float(c), dtype=torch.float32))
        logits = torch.einsum("bnc,bmc->bnm", q, k).float() * scale
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        y = self.to_out[0](torch.einsum("bnm,bmc->bnc", weights, v))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEDownsample(nn.Module):
    """diffusers Downsample2D of the VAE: pad (0, 1) on the bottom and right,
    then a stride-2 3x3 convolution without padding."""

    def __init__(self, channels, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid_block(ch, groups, dt):
    mid = UNetBlock()
    mid.resnets.append(ResnetBlock(ch, ch, 0, dt, groups))
    mid.attentions.append(VAEAttention(ch, groups, dt))
    mid.resnets.append(ResnetBlock(ch, ch, 0, dt, groups))
    return mid


def _run_mid(mid, h):
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        dt, groups, chans = cfg.dtype, cfg.norm_groups, cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1, compute_dtype=dt)
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            block = UNetBlock()
            for _ in range(cfg.layers_per_block):
                block.resnets.append(ResnetBlock(cin, ch, 0, dt, groups))
                cin = ch
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList([VAEDownsample(ch, dt)])
            self.down_blocks.append(block)
        self.mid_block = _mid_block(cin, groups, dt)
        self.conv_norm_out = GroupNorm(groups, cin, eps=1e-6)
        self.conv_out = Conv2d(cin, 2 * cfg.latent_channels, 3, padding=1,
                               compute_dtype=torch.float32)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        dt, groups = cfg.dtype, cfg.norm_groups
        chans = tuple(reversed(cfg.block_out_channels))
        cin = chans[0]
        self.conv_in = Conv2d(cfg.latent_channels, cin, 3, padding=1, compute_dtype=dt)
        self.mid_block = _mid_block(cin, groups, dt)
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(chans):
            block = UNetBlock()
            for _ in range(cfg.layers_per_block + 1):
                block.resnets.append(ResnetBlock(cin, ch, 0, dt, groups))
                cin = ch
            if i < len(chans) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch, dt)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm(groups, cin, eps=1e-6)
        self.conv_out = Conv2d(cin, cfg.in_channels, 3, padding=1, compute_dtype=torch.float32)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEEncoder(nn.Module):
    """rgb (B, 3, H, W) in [-1, 1] -> latent moments (B, 2 * latent, H/8,
    W/8) f32 (with the SD VAE's three downsamples)."""

    def __init__(self, cfg: AutoencoderKLConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                 compute_dtype=torch.float32)

    def forward(self, x):
        """The encode, inside the ``guidance/encode`` span."""
        with span("guidance/encode"):
            return self.quant_conv(self.encoder(x.to(self.cfg.dtype)).float())


class VAEDecoder(nn.Module):
    """Unscaled latent (B, latent, h, w) -> rgb (B, 3, 8h, 8w) in [-1, 1]."""

    def __init__(self, cfg: AutoencoderKLConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                      compute_dtype=torch.float32)
        self.decoder = Decoder(cfg)

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z).to(self.cfg.dtype)).float()


def vae_half(state_dict: Dict[str, torch.Tensor], half: str) -> Dict[str, torch.Tensor]:
    """The ``encoder`` (with ``quant_conv``) or ``decoder`` (with
    ``post_quant_conv``) keys of a diffusers AutoencoderKL state dict."""
    quant = {"encoder": "quant_conv.", "decoder": "post_quant_conv."}[half]
    return {k: v for k, v in state_dict.items() if k.startswith((half + ".", quant))}


def sample_latents(moments: torch.Tensor, scaling_factor: float, generator=None, noise=None):
    """moments (B, 2C, h, w) -> scaled latent sample (B, C, h, w).  The
    standard normal draw comes from ``generator`` unless ``noise`` is
    given (tests feed the JAX package's draw)."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=generator.device)
    return (mean + std * noise.to(mean.device)) * scaling_factor
