"""Plain reference of the two diffusion models the cells run: the latent
UNet (Stable Diffusion 2.1-base, and MVDream's 4-view variant of it) and
the SD VAE encoder, written from the published architectures
(diffusers' ``UNet2DConditionModel`` / ``AutoencoderKL`` and MVDream's
``MultiViewUNetModel``) as functions over a dict of weights in diffusers'
key layout.  Nothing here imports the program.

Every product (convolution, dense layer, attention's two matmuls) goes
through a ``Precision``: ``f32`` is the reference itself (the caller turns
TF32 off), the others are the controls of the benchmark's check, the
reference computed one precision below the one the configuration states.
Norms, softmax and the elementwise work stay in float32 in every mode.

Departures of the program from the published models that the reference
does not copy: the program's GEGLU takes the tanh-approximate GELU (the
published models take the exact one) and its VAE resnets normalise with
epsilon 1e-5 (published 1e-6)."""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference computes its products: ``f32`` (the reference),
    ``bf16`` (operands and result in bfloat16, the control of a float32
    configuration whose convolutions run in TF32) or ``fp8`` (operands
    rounded to float8 e4m3 per tensor, the control of a bfloat16
    configuration)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _ops(self, *xs):
        if self.name == "bf16":
            return [x.to(torch.bfloat16) for x in xs]
        if self.name == "fp8":
            return [_fp8(x) for x in xs]
        return list(xs)

    def conv(self, x, w, b, stride=1, padding=0):
        xx, ww = self._ops(x, w)
        bb = None if b is None else b.to(xx.dtype)
        return F.conv2d(xx, ww, bb, stride, padding).float()

    def linear(self, x, w, b=None):
        xx, ww = self._ops(x, w)
        bb = None if b is None else b.to(xx.dtype)
        return F.linear(xx, ww, bb).float()

    def matmul(self, a, b):
        aa, bb = self._ops(a, b)
        return torch.matmul(aa, bb).float()


F32 = Precision("f32")


def _gn(x, groups, w, b, eps):
    return F.group_norm(x.float(), groups, w.float(), b.float(), eps)


def _ln(x, w, b, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def attention(P: Precision, q, k, v, chunk: int = 16):
    """softmax(q k^T / sqrt(d)) v over (bh, n, d) operands, in chunks of
    ``chunk`` rows of bh so that the scores fit."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for i in range(0, q.shape[0], chunk):
        s = P.matmul(q[i:i + chunk], k[i:i + chunk].transpose(1, 2)) * scale
        p = torch.softmax(s, dim=-1)
        outs.append(P.matmul(p, v[i:i + chunk]))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# UNet (diffusers UNet2DConditionModel; MVDream's multi-view variant)
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal features, flip_sin_to_cos: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _resnet(W, p, x, temb, groups, eps, P):
    h = P.conv(F.silu(_gn(x, groups, W[p + "norm1.weight"], W[p + "norm1.bias"], eps)),
               W[p + "conv1.weight"], W[p + "conv1.bias"], 1, 1)
    if temb is not None:
        h = h + P.linear(F.silu(temb), W[p + "time_emb_proj.weight"],
                         W[p + "time_emb_proj.bias"])[:, :, None, None]
    h = P.conv(F.silu(_gn(h, groups, W[p + "norm2.weight"], W[p + "norm2.bias"], eps)),
               W[p + "conv2.weight"], W[p + "conv2.bias"], 1, 1)
    if p + "conv_shortcut.weight" in W:
        x = P.conv(x, W[p + "conv_shortcut.weight"], W[p + "conv_shortcut.bias"])
    return x + h


def _mha(W, p, x, ctx, heads, P):
    """Multi-head attention without q/k/v biases; x (b, n, c), ctx (b, m, c')."""
    q = P.linear(x, W[p + "to_q.weight"])
    k = P.linear(ctx, W[p + "to_k.weight"])
    v = P.linear(ctx, W[p + "to_v.weight"])
    b, n, inner = q.shape
    m = k.shape[1]
    d = inner // heads

    def split(t, length):
        return t.reshape(b, length, heads, d).transpose(1, 2).reshape(b * heads, length, d)

    o = attention(P, split(q, n), split(k, m), split(v, m))
    o = o.reshape(b, heads, n, d).transpose(1, 2).reshape(b, n, inner)
    return P.linear(o, W[p + "to_out.0.weight"], W[p + "to_out.0.bias"])


def _transformer(W, p, x, ctx, heads, groups, use_linear, num_views, P):
    b, c, h, w = x.shape
    res = x
    x = _gn(x, groups, W[p + "norm.weight"], W[p + "norm.bias"], 1e-6)
    if use_linear:
        x = P.linear(x.permute(0, 2, 3, 1).reshape(b, h * w, c), W[p + "proj_in.weight"],
                     W[p + "proj_in.bias"])
    else:
        x = P.conv(x, W[p + "proj_in.weight"], W[p + "proj_in.bias"])
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    tb = p + "transformer_blocks.0."
    h1 = _ln(x, W[tb + "norm1.weight"], W[tb + "norm1.bias"])
    if num_views > 1:  # MVDream: the views of a scene attend as one sequence
        n = h * w
        a = _mha(W, tb + "attn1.", h1.reshape(b // num_views, num_views * n, c),
                 h1.reshape(b // num_views, num_views * n, c), heads, P)
        x = x + a.reshape(b, n, c)
    else:
        x = x + _mha(W, tb + "attn1.", h1, h1, heads, P)
    x = x + _mha(W, tb + "attn2.", _ln(x, W[tb + "norm2.weight"], W[tb + "norm2.bias"]), ctx,
                 heads, P)
    h3 = _ln(x, W[tb + "norm3.weight"], W[tb + "norm3.bias"])
    a, gate = P.linear(h3, W[tb + "ff.net.0.proj.weight"], W[tb + "ff.net.0.proj.bias"]).chunk(2, -1)
    x = x + P.linear(a * F.gelu(gate), W[tb + "ff.net.2.weight"], W[tb + "ff.net.2.bias"])
    if use_linear:
        x = P.linear(x, W[p + "proj_out.weight"], W[p + "proj_out.bias"])
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        x = P.conv(x.reshape(b, h, w, c).permute(0, 3, 1, 2), W[p + "proj_out.weight"],
                   W[p + "proj_out.bias"])
    return x + res


def _heads(cfg) -> Tuple[int, ...]:
    """Heads per level: SD 2.x's config names them ``attention_head_dim``
    (diffusers' legacy naming; the head size is channels / heads = 64)."""
    n = len(cfg["block_out_channels"])
    ahd = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return tuple(ahd) if isinstance(ahd, (list, tuple)) else (ahd,) * n


def unet_forward(W: Dict[str, torch.Tensor], cfg: dict, x, t, ctx, camera=None,
                 P: Precision = F32) -> torch.Tensor:
    """eps (B, out, h, w) of latents x (B, in, h, w) at timesteps t (B,)
    under context ctx (B, L, D); a multi-view config (``num_views`` > 1)
    also takes camera (B, ``camera_embed_dim``), the views of a scene
    consecutive."""
    chans = cfg["block_out_channels"]
    groups, eps = cfg.get("norm_num_groups", 32), cfg.get("norm_eps", 1e-5)
    heads = _heads(cfg)
    use_linear = cfg.get("use_linear_projection", False)
    views = cfg.get("num_views", 1)
    layers = cfg.get("layers_per_block", 2)

    temb = timestep_embedding(t, chans[0], cfg.get("freq_shift", 0))
    temb = P.linear(F.silu(P.linear(temb, W["time_embedding.linear_1.weight"],
                                    W["time_embedding.linear_1.bias"])),
                    W["time_embedding.linear_2.weight"], W["time_embedding.linear_2.bias"])
    if cfg.get("camera_embed_dim"):
        cam = P.linear(F.silu(P.linear(camera.float(), W["camera_embedding.linear_1.weight"],
                                       W["camera_embedding.linear_1.bias"])),
                       W["camera_embedding.linear_2.weight"], W["camera_embedding.linear_2.bias"])
        temb = temb + cam
    ctx = ctx.float()

    def tr(p, h, level):
        return _transformer(W, p, h, ctx, heads[level], groups, use_linear, views, P)

    h = P.conv(x.float(), W["conv_in.weight"], W["conv_in.bias"], 1, 1)
    skips = [h]
    for i, btype in enumerate(cfg["down_block_types"]):
        for j in range(layers):
            h = _resnet(W, f"down_blocks.{i}.resnets.{j}.", h, temb, groups, eps, P)
            if btype.startswith("CrossAttn"):
                h = tr(f"down_blocks.{i}.attentions.{j}.", h, i)
            skips.append(h)
        if i < len(chans) - 1:
            h = P.conv(h, W[f"down_blocks.{i}.downsamplers.0.conv.weight"],
                       W[f"down_blocks.{i}.downsamplers.0.conv.bias"], 2, 1)
            skips.append(h)
    h = _resnet(W, "mid_block.resnets.0.", h, temb, groups, eps, P)
    h = tr("mid_block.attentions.0.", h, len(chans) - 1)
    h = _resnet(W, "mid_block.resnets.1.", h, temb, groups, eps, P)
    for i, btype in enumerate(cfg["up_block_types"]):
        level = len(chans) - 1 - i
        for j in range(layers + 1):
            h = _resnet(W, f"up_blocks.{i}.resnets.{j}.", torch.cat([h, skips.pop()], 1), temb,
                        groups, eps, P)
            if btype.startswith("CrossAttn"):
                h = tr(f"up_blocks.{i}.attentions.{j}.", h, level)
        if i < len(chans) - 1:
            h = P.conv(F.interpolate(h, scale_factor=2, mode="nearest"),
                       W[f"up_blocks.{i}.upsamplers.0.conv.weight"],
                       W[f"up_blocks.{i}.upsamplers.0.conv.bias"], 1, 1)
    h = F.silu(_gn(h, groups, W["conv_norm_out.weight"], W["conv_norm_out.bias"], eps))
    return P.conv(h, W["conv_out.weight"], W["conv_out.bias"], 1, 1)


def unet_shapes(cfg: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the UNet by its diffusers key, with its shape."""
    S: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    chans = cfg["block_out_channels"]
    c0, temb_dim = chans[0], chans[0] * 4
    cross = cfg["cross_attention_dim"]
    use_linear = cfg.get("use_linear_projection", False)
    layers = cfg.get("layers_per_block", 2)

    def conv(p, cin, cout, k):
        S[p + "weight"] = (cout, cin, k, k)
        S[p + "bias"] = (cout,)

    def dense(p, cin, cout, bias=True):
        S[p + "weight"] = (cout, cin)
        if bias:
            S[p + "bias"] = (cout,)

    def norm(p, c):
        S[p + "weight"] = (c,)
        S[p + "bias"] = (c,)

    def resnet(p, cin, cout):
        norm(p + "norm1.", cin)
        conv(p + "conv1.", cin, cout, 3)
        dense(p + "time_emb_proj.", temb_dim, cout)
        norm(p + "norm2.", cout)
        conv(p + "conv2.", cout, cout, 3)
        if cin != cout:
            conv(p + "conv_shortcut.", cin, cout, 1)

    def transformer(p, c):
        norm(p + "norm.", c)
        (dense if use_linear else lambda q, a, b: conv(q, a, b, 1))(p + "proj_in.", c, c)
        tb = p + "transformer_blocks.0."
        for a, ctx_dim in (("attn1.", c), ("attn2.", cross)):
            norm(tb + "norm" + a[-2] + ".", c)
            dense(tb + a + "to_q.", c, c, False)
            dense(tb + a + "to_k.", ctx_dim, c, False)
            dense(tb + a + "to_v.", ctx_dim, c, False)
            dense(tb + a + "to_out.0.", c, c)
        norm(tb + "norm3.", c)
        dense(tb + "ff.net.0.proj.", c, 8 * c)
        dense(tb + "ff.net.2.", 4 * c, c)
        (dense if use_linear else lambda q, a, b: conv(q, a, b, 1))(p + "proj_out.", c, c)

    conv("conv_in.", cfg.get("in_channels", 4), c0, 3)
    dense("time_embedding.linear_1.", c0, temb_dim)
    dense("time_embedding.linear_2.", temb_dim, temb_dim)
    if cfg.get("camera_embed_dim"):
        dense("camera_embedding.linear_1.", cfg["camera_embed_dim"], temb_dim)
        dense("camera_embedding.linear_2.", temb_dim, temb_dim)
    skip = [c0]
    cin = c0
    for i, (btype, ch) in enumerate(zip(cfg["down_block_types"], chans)):
        for j in range(layers):
            resnet(f"down_blocks.{i}.resnets.{j}.", cin, ch)
            if btype.startswith("CrossAttn"):
                transformer(f"down_blocks.{i}.attentions.{j}.", ch)
            cin = ch
            skip.append(ch)
        if i < len(chans) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv.", ch, ch, 3)
            skip.append(ch)
    resnet("mid_block.resnets.0.", cin, cin)
    transformer("mid_block.attentions.0.", cin)
    resnet("mid_block.resnets.1.", cin, cin)
    for i, (btype, ch) in enumerate(zip(cfg["up_block_types"], reversed(chans))):
        for j in range(layers + 1):
            resnet(f"up_blocks.{i}.resnets.{j}.", cin + skip.pop(), ch)
            if btype.startswith("CrossAttn"):
                transformer(f"up_blocks.{i}.attentions.{j}.", ch)
            cin = ch
        if i < len(chans) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv.", ch, ch, 3)
    norm("conv_norm_out.", c0)
    conv("conv_out.", c0, cfg.get("out_channels", 4), 3)
    return S


# ---------------------------------------------------------------------------
# VAE encoder (diffusers AutoencoderKL's encoder and quant_conv)
# ---------------------------------------------------------------------------


def vae_encode(W: Dict[str, torch.Tensor], cfg: dict, x, P: Precision = F32) -> torch.Tensor:
    """Latent moments (B, 2 latent, H/8, W/8) of x (B, 3, H, W) in [-1, 1]."""
    groups, eps = cfg.get("norm_num_groups", 32), 1e-6
    chans = cfg["block_out_channels"]
    h = P.conv(x.float(), W["encoder.conv_in.weight"], W["encoder.conv_in.bias"], 1, 1)
    for i in range(len(chans)):
        for j in range(cfg.get("layers_per_block", 2)):
            h = _resnet(W, f"encoder.down_blocks.{i}.resnets.{j}.", h, None, groups, eps, P)
        if i < len(chans) - 1:
            h = P.conv(F.pad(h, (0, 1, 0, 1)), W[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"],
                       W[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"], 2, 0)
    h = _resnet(W, "encoder.mid_block.resnets.0.", h, None, groups, eps, P)
    # the mid block's single-head self-attention with biased projections
    p = "encoder.mid_block.attentions.0."
    b, c, hh, ww = h.shape
    y = _gn(h, groups, W[p + "group_norm.weight"], W[p + "group_norm.bias"], eps)
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    q, k, v = (P.linear(y, W[p + f"to_{n}.weight"], W[p + f"to_{n}.bias"]) for n in "qkv")
    y = P.linear(attention(P, q, k, v, chunk=1), W[p + "to_out.0.weight"], W[p + "to_out.0.bias"])
    h = h + y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    h = _resnet(W, "encoder.mid_block.resnets.1.", h, None, groups, eps, P)
    h = F.silu(_gn(h, groups, W["encoder.conv_norm_out.weight"], W["encoder.conv_norm_out.bias"],
                   eps))
    h = P.conv(h, W["encoder.conv_out.weight"], W["encoder.conv_out.bias"], 1, 1)
    return P.conv(h, W["quant_conv.weight"], W["quant_conv.bias"])


def vae_encoder_shapes(cfg: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the VAE's encoder and quant_conv by diffusers key."""
    S: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    chans = cfg["block_out_channels"]
    lat = cfg.get("latent_channels", 4)

    def conv(p, cin, cout, k):
        S[p + "weight"] = (cout, cin, k, k)
        S[p + "bias"] = (cout,)

    def norm(p, c):
        S[p + "weight"] = (c,)
        S[p + "bias"] = (c,)

    def resnet(p, cin, cout):
        norm(p + "norm1.", cin)
        conv(p + "conv1.", cin, cout, 3)
        norm(p + "norm2.", cout)
        conv(p + "conv2.", cout, cout, 3)
        if cin != cout:
            conv(p + "conv_shortcut.", cin, cout, 1)

    conv("encoder.conv_in.", cfg.get("in_channels", 3), chans[0], 3)
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg.get("layers_per_block", 2)):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}.", cin, ch)
            cin = ch
        if i < len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.", ch, ch, 3)
    resnet("encoder.mid_block.resnets.0.", cin, cin)
    p = "encoder.mid_block.attentions.0."
    norm(p + "group_norm.", cin)
    for n in ("to_q.", "to_k.", "to_v.", "to_out.0."):
        S[p + n + "weight"] = (cin, cin)
        S[p + n + "bias"] = (cin,)
    resnet("encoder.mid_block.resnets.1.", cin, cin)
    norm("encoder.conv_norm_out.", cin)
    conv("encoder.conv_out.", cin, 2 * lat, 3)
    conv("quant_conv.", 2 * lat, 2 * lat, 1)
    return S


def sample_latents(moments: torch.Tensor, noise: torch.Tensor, scaling: float) -> torch.Tensor:
    """The scaled latent sample of the diagonal Gaussian the moments give."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return (mean + std * noise) * scaling


def load_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """A weights file the benchmark wrote, in float32 on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
