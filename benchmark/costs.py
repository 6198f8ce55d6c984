"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
text-to-3D step's diffusion models worked out from the configuration's
shapes, and K5's bound at a shape.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 495 TF32, 67 float32 on the
CUDA cores, 3.35 TB/s of HBM; the SFU's 16 exponentials a clock per SM
over 132 SMs at the card's highest SM clock."""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK = 16 * 132
SM_MAX_HZ = 1.98e9  # the H100 SXM's highest SM clock, when nvidia-smi gives none


def _heads(unet: dict):
    n = len(unet["block_out_channels"])
    ahd = unet.get("num_attention_heads") or unet["attention_head_dim"]
    return list(ahd) if isinstance(ahd, (list, tuple)) else [ahd] * n


def conv_flops(b, cin, cout, k, h_out, w_out) -> float:
    return 2.0 * b * cin * cout * k * k * h_out * w_out


def unet_flops(unet: dict, batch: int, h: int, w: int, ctx_len: int,
               long_tokens: int = 1024) -> Dict[str, float]:
    """Forward FLOPs of one UNet call on ``batch`` latents of h x w, by
    kind: "conv" (3x3 and 1x1 convolutions; "conv_out" apart, which the
    program runs in float32), "dense" (projections, feed-forward, time and
    camera embeddings), "attn_long" (self-attention products over at
    least ``long_tokens`` tokens, K5's on the card) and "attn_short" (the
    other attention products)."""
    f = {"conv": 0.0, "conv_out": 0.0, "dense": 0.0, "attn_long": 0.0, "attn_short": 0.0}
    chans = unet["block_out_channels"]
    heads = _heads(unet)
    layers = unet.get("layers_per_block", 2)
    cross = unet["cross_attention_dim"]
    views = unet.get("num_views", 1)
    c0, temb = chans[0], 4 * chans[0]
    lin = unet.get("use_linear_projection", False)
    f["dense"] += 2.0 * batch * (c0 * temb + temb * temb)
    if unet.get("camera_embed_dim"):
        f["dense"] += 2.0 * batch * (unet["camera_embed_dim"] * temb + temb * temb)

    def resnet(cin, cout, hh, ww):
        f["conv"] += conv_flops(batch, cin, cout, 3, hh, ww) + conv_flops(batch, cout, cout, 3, hh, ww)
        f["dense"] += 2.0 * batch * temb * cout
        if cin != cout:
            f["conv"] += conv_flops(batch, cin, cout, 1, hh, ww)

    def transformer(c, hh, ww, nh):
        n = hh * ww
        proj = 2 * 2.0 * batch * n * c * c
        f["dense" if lin else "conv"] += proj
        # self-attention: q, k, v, out; cross: q, out on tokens, k, v on the context
        f["dense"] += 4 * 2.0 * batch * n * c * c
        f["dense"] += 2 * 2.0 * batch * n * c * c + 2 * 2.0 * batch * ctx_len * cross * c
        f["dense"] += 2.0 * batch * n * c * 8 * c + 2.0 * batch * n * 4 * c * c  # GEGLU, out
        seq = n * views  # MVDream: a scene's views are one sequence
        self_attn = 4.0 * (batch // views) * seq * seq * c
        f["attn_long" if seq >= long_tokens else "attn_short"] += self_attn
        f["attn_short"] += 4.0 * batch * n * ctx_len * c

    hh, ww = h, w
    f["conv"] += conv_flops(batch, unet.get("in_channels", 4), c0, 3, hh, ww)
    skip = [c0]
    cin = c0
    for i, (btype, ch) in enumerate(zip(unet["down_block_types"], chans)):
        for _ in range(layers):
            resnet(cin, ch, hh, ww)
            if btype.startswith("CrossAttn"):
                transformer(ch, hh, ww, heads[i])
            cin = ch
            skip.append(ch)
        if i < len(chans) - 1:
            hh, ww = hh // 2, ww // 2
            f["conv"] += conv_flops(batch, ch, ch, 3, hh, ww)
            skip.append(ch)
    resnet(cin, cin, hh, ww)
    transformer(cin, hh, ww, heads[-1])
    resnet(cin, cin, hh, ww)
    for i, (btype, ch) in enumerate(zip(unet["up_block_types"], reversed(chans))):
        for _ in range(layers + 1):
            resnet(cin + skip.pop(), ch, hh, ww)
            if btype.startswith("CrossAttn"):
                transformer(ch, hh, ww, heads[len(chans) - 1 - i])
            cin = ch
        if i < len(chans) - 1:
            hh, ww = hh * 2, ww * 2
            f["conv"] += conv_flops(batch, ch, ch, 3, hh, ww)
    f["conv_out"] += conv_flops(batch, c0, unet.get("out_channels", 4), 3, hh, ww)
    return f


def vae_encoder_flops(vae: dict, batch: int, h: int, w: int) -> Dict[str, float]:
    """Forward FLOPs of the VAE encoder and quant_conv on ``batch`` images
    of h x w, by kind: "conv", "conv_out" (conv_out and quant_conv, float32
    in the program), "dense" (the mid block's projections) and "attn" (its
    single-head self-attention products)."""
    f = {"conv": 0.0, "conv_out": 0.0, "dense": 0.0, "attn": 0.0}
    chans = vae["block_out_channels"]
    lat = vae.get("latent_channels", 4)
    hh, ww = h, w
    f["conv"] += conv_flops(batch, vae.get("in_channels", 3), chans[0], 3, hh, ww)
    cin = chans[0]

    def resnet(a, b):
        f["conv"] += conv_flops(batch, a, b, 3, hh, ww) + conv_flops(batch, b, b, 3, hh, ww)
        if a != b:
            f["conv"] += conv_flops(batch, a, b, 1, hh, ww)

    for i, ch in enumerate(chans):
        for _ in range(vae.get("layers_per_block", 2)):
            resnet(cin, ch)
            cin = ch
        if i < len(chans) - 1:
            hh, ww = hh // 2, ww // 2
            f["conv"] += conv_flops(batch, ch, ch, 3, hh, ww)
    resnet(cin, cin)
    n = hh * ww
    f["dense"] += 4 * 2.0 * batch * n * cin * cin
    f["attn"] += 4.0 * batch * n * n * cin
    resnet(cin, cin)
    f["conv_out"] += conv_flops(batch, cin, 2 * lat, 3, hh, ww) + conv_flops(batch, 2 * lat, 2 * lat,
                                                                             1, hh, ww)
    return f


def vae_backward_to_input(fwd: Dict[str, float]) -> Dict[str, float]:
    """FLOPs of the backward to the input of frozen weights: each product
    once more for its data gradient, attention's two products twice."""
    return {k: (2.0 * v if k == "attn" else v) for k, v in fwd.items()}


def k5_bound_s(bh: int, n: int, d: int, dtype: str, sm_hz: float = SM_MAX_HZ) -> Tuple[float, str]:
    """The least time of one K5 launch at (bh, n, d) and which term sets it:
    q, k, v read once and o written once at the HBM peak; the 4 bh n^2 d
    FLOPs of the two products at their peak (bf16: the tensor cores; f32,
    held to float32 accuracy: the faster of the CUDA cores and the
    three-plane bf16 split, 12 products of 2 bh n^2 d FLOPs each); the
    bh n^2 exponentials on the SFU."""
    elt = 2 if dtype == "bf16" else 4
    terms = {"bytes": 4.0 * bh * n * d * elt / PEAK_BYTES}
    flops = 4.0 * bh * n * n * d
    terms["products"] = (flops / PEAK_BF16 if dtype == "bf16"
                         else min(flops / PEAK_F32, 12 * (flops / 2) / PEAK_BF16))
    terms["sfu"] = bh * n * n / (SFU_PER_CLOCK * sm_hz)
    term = max(terms, key=terms.get)
    return terms[term], term
