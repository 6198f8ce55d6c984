"""Conditional UNet for latent diffusion (SD 2.1 / Zero123 / MVDream class),
PyTorch, NCHW (port of the JAX package's ``diffusion/unet.py``).

Module and parameter names follow diffusers' ``UNet2DConditionModel`` key
layout, so a diffusers ``state_dict`` loads with ``load_state_dict(strict=
True)``.  Compute types follow the JAX package's Flax semantics, so its bf16
path and this one round at the same places:

  * convolutions and dense layers cast their input and weights to the
    config's ``dtype`` and return that type (Flax ``dtype=``);
  * GroupNorm and LayerNorm compute in f32 and return f32 (Flax promotes a
    bf16 input with f32 scale and bias to f32); their weights stay f32;
  * ``conv_out`` computes in f32 and the output is f32;
  * attention goes through ``ops.flash_attention.attention``: K5 for long
    self-attention on the card (forward only, which SDS allows because the
    denoiser runs under ``torch.no_grad``), the einsum with an f32 softmax
    otherwise.

Multiview configs (MVDream) fold ``num_views`` consecutive views into one
token sequence for self-attention and add a camera MLP to the time
embedding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import attention as _attention
from ..utils.tracing import span


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)  # heads per level
    cross_attention_dim: int = 1024
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    use_linear_projection: bool = True  # SD 2.x; Zero123 / SD 1.x use 1x1 convs
    freq_shift: float = 0.0
    norm_groups: int = 32
    dtype: torch.dtype = torch.float32  # compute type of convolutions and dense layers
    # multiview (MVDream): the batch is num_views consecutive views of one
    # scene, and self-attention attends over all their tokens jointly
    num_views: int = 1
    camera_embed_dim: int = 0  # 16 = flattened 4x4 c2w (MVDream)


SD21_UNET = UNet2DConditionConfig()
ZERO123_UNET = UNet2DConditionConfig(
    in_channels=8,
    cross_attention_dim=768,
    attention_head_dim=(8, 8, 8, 8),
    use_linear_projection=False,
)
MVDREAM_UNET = UNet2DConditionConfig(num_views=4, camera_embed_dim=16)


def timestep_embedding(t: torch.Tensor, dim: int, freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep features, diffusers ``Timesteps`` with
    flip_sin_to_cos=True: [cos | sin], f32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# Layers with the JAX package's compute types
# ---------------------------------------------------------------------------


class Conv2d(nn.Conv2d):
    """Convolution computing in ``compute_dtype`` (Flax ``nn.Conv(dtype=)``)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, compute_dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding)


class Linear(nn.Linear):
    """Dense layer computing in ``compute_dtype`` (Flax ``nn.Dense(dtype=)``)."""

    def __init__(self, cin, cout, bias=True, compute_dtype=torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in f32 with an f32 result, whatever the input type."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 with an f32 result, whatever the input type."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D.  ``temb_dim`` 0 builds no ``time_emb_proj``
    (the VAE's resnets carry none).  GroupNorm epsilon 1e-5, as the JAX
    package's ResnetBlock uses in the UNet and the VAE alike."""

    def __init__(self, cin, cout, temb_dim, dtype, groups, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, compute_dtype=dtype)
        self.time_emb_proj = Linear(temb_dim, cout, compute_dtype=dtype) if temb_dim else None
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, compute_dtype=dtype)
        self.conv_shortcut = Conv2d(cin, cout, 1, compute_dtype=dtype) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention without q/k/v biases (diffusers ``Attention``)."""

    def __init__(self, query_dim, heads, dim_head, dtype, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, compute_dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, compute_dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, compute_dtype=dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, compute_dtype=dtype), nn.Identity()])

    def forward(self, x, context=None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, n, _ = q.shape
        m = k.shape[1]
        q = q.reshape(b, n, self.heads, self.dim_head)
        k = k.reshape(b, m, self.heads, self.dim_head)
        v = v.reshape(b, m, self.heads, self.dim_head)
        out = _attention(q, k, v, 1.0 / math.sqrt(float(self.dim_head)))
        return self.to_out[0](out.reshape(b, n, self.heads * self.dim_head))


class GEGLU(nn.Module):
    """``ff.net.0``: one projection to [a | gate], then a * gelu(gate) with
    the tanh approximation (Flax ``nn.gelu``; diffusers uses exact GELU)."""

    def __init__(self, dim, inner, dtype):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, compute_dtype=dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, dtype):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, dtype), nn.Identity(),
                                  Linear(4 * dim, dim, compute_dtype=dtype)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, cross_dim, dtype, num_views=1):
        super().__init__()
        self.num_views = num_views
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, dtype, context_dim=cross_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, context):
        h1 = self.norm1(x)
        if self.num_views > 1:
            # MVDream 3D attention: the views of a scene are one sequence
            bv, n, c = h1.shape
            v = self.num_views
            x = x + self.attn1(h1.reshape(bv // v, v * n, c)).reshape(bv, n, c)
        else:
            x = x + self.attn1(h1)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (epsilon 1e-6), in-projection (dense or 1x1 conv), one
    transformer block over the h*w tokens, out-projection, residual."""

    def __init__(self, channels, heads, cross_dim, use_linear, dtype, groups, num_views=1):
        super().__init__()
        self.use_linear = use_linear
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        if use_linear:
            self.proj_in = Linear(channels, channels, compute_dtype=dtype)
            self.proj_out = Linear(channels, channels, compute_dtype=dtype)
        else:
            self.proj_in = Conv2d(channels, channels, 1, compute_dtype=dtype)
            self.proj_out = Conv2d(channels, channels, 1, compute_dtype=dtype)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            channels, heads, channels // heads, cross_dim, dtype, num_views)])

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.transformer_blocks[0](x, context)
        if self.use_linear:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return x + residual


class Downsample(nn.Module):
    """Stride-2 3x3 convolution with symmetric padding 1."""

    def __init__(self, channels, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 (``jax.image.resize(..., "nearest")`` at exactly 2x), then
    a 3x3 convolution."""

    def __init__(self, channels, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetBlock(nn.Module):
    """A down, mid or up block: ``resnets``, ``attentions`` (empty for the
    plain block types) and ``downsamplers`` / ``upsamplers``."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim, dtype):
        super().__init__()
        self.linear_1 = Linear(cin, dim, compute_dtype=dtype)
        self.linear_2 = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DCondition(nn.Module):
    """forward(latent (B, Cin, H, W), t (B,), context (B, L, D)) -> eps
    (B, Cout, H, W) f32.  Multiview configs also take camera (B,
    camera_embed_dim); B is a multiple of num_views with the views of one
    scene consecutive."""

    def __init__(self, cfg: UNet2DConditionConfig = SD21_UNET):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        chans = cfg.block_out_channels
        ch0 = chans[0]
        temb_dim = ch0 * 4
        groups = cfg.norm_groups

        def transformer(ch, heads):
            return Transformer2D(ch, heads, cfg.cross_attention_dim, cfg.use_linear_projection,
                                 dt, groups, cfg.num_views)

        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1, compute_dtype=dt)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim, dt)
        self.camera_embedding = (
            TimestepEmbedding(cfg.camera_embed_dim, temb_dim, dt) if cfg.camera_embed_dim else None
        )

        self.down_blocks = nn.ModuleList()
        skip_chans = [ch0]
        cin = ch0
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, chans)):
            block = UNetBlock()
            for _ in range(cfg.layers_per_block):
                block.resnets.append(ResnetBlock(cin, ch, temb_dim, dt, groups))
                if btype == "CrossAttnDownBlock2D":
                    block.attentions.append(transformer(ch, cfg.attention_head_dim[i]))
                cin = ch
                skip_chans.append(ch)
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList([Downsample(ch, dt)])
                skip_chans.append(ch)
            self.down_blocks.append(block)

        self.mid_block = UNetBlock()
        self.mid_block.resnets.append(ResnetBlock(cin, cin, temb_dim, dt, groups))
        self.mid_block.attentions.append(transformer(cin, cfg.attention_head_dim[-1]))
        self.mid_block.resnets.append(ResnetBlock(cin, cin, temb_dim, dt, groups))

        self.up_blocks = nn.ModuleList()
        rev_heads = tuple(reversed(cfg.attention_head_dim))
        for i, (btype, ch) in enumerate(zip(cfg.up_block_types, reversed(chans))):
            block = UNetBlock()
            for _ in range(cfg.layers_per_block + 1):
                block.resnets.append(ResnetBlock(cin + skip_chans.pop(), ch, temb_dim, dt, groups))
                if btype == "CrossAttnUpBlock2D":
                    block.attentions.append(transformer(ch, rev_heads[i]))
                cin = ch
            if i < len(chans) - 1:
                block.upsamplers = nn.ModuleList([Upsample(ch, dt)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm(groups, ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1, compute_dtype=torch.float32)

    def forward(self, x, t, context, camera=None):
        """The call, inside the ``guidance/unet`` span."""
        with span("guidance/unet"):
            return self._forward(x, t, context, camera)

    def _forward(self, x, t, context, camera):
        cfg = self.cfg
        dt = cfg.dtype
        temb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0], cfg.freq_shift))
        if self.camera_embedding is not None:
            cam = (torch.zeros((x.shape[0], cfg.camera_embed_dim), dtype=dt, device=x.device)
                   if camera is None else camera.to(dt))
            temb = temb + self.camera_embedding(cam)
        context = context.to(dt)
        h = self.conv_in(x.to(dt))

        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()
