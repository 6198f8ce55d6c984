"""Plain reference of the CLIP image tower (OpenAI CLIP ViT, as
``transformers``' ``CLIPVisionModelWithProjection`` lays it out: Radford
et al. 2021; openai/clip-vit-large-patch14), in float32 over a dict of
weights in its key layout, and the antialiased bilinear resize and
normalisation in front of it.  Nothing here imports the program.

  * patch embedding: a stride-``patch_size`` convolution without bias; the
    class embedding in front of the patches; the learned position
    embedding added; ``pre_layrnorm``;
  * ``num_hidden_layers`` pre-LN blocks: x + attn(LN1(x)), x + MLP(LN2(x)),
    with q, k, v and out projections with biases, softmax(q k^T / sqrt(d)),
    no mask, and the MLP fc1 -> ``hidden_act`` -> fc2;
  * ``post_layernorm`` of the class token, then ``visual_projection``
    (no bias): the ``image_embeds``.

Products go through a ``diffusion.Precision``, as in ``diffusion.py``."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import diffusion

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"hidden_act {name!r}")


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of a half-pixel bilinear resize: a triangle
    filter over the input pixel centres, widened by the shrink factor when
    shrinking (the antialiased resize), each row normalised to sum 1."""
    scale = n_out / n_in
    support = 1.0 / min(scale, 1.0)
    src = torch.arange(n_in, dtype=torch.float64) + 0.5
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale
    w = torch.clamp(1.0 - (src[None, :] - centre[:, None]).abs() / support, min=0.0)
    return (w / w.sum(dim=1, keepdim=True)).float().to(device)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) by the separable bilinear resize
    above (the identity at the same size)."""
    if x.shape[-2:] == (size, size):
        return x
    rows = _resize_matrix(x.shape[-2], size, x.device)
    cols = _resize_matrix(x.shape[-1], size, x.device)
    return torch.einsum("oh,bchw,pw->bcop", rows, x.float(), cols)


def image_embeds(W: Dict[str, torch.Tensor], cfg: dict, frames: torch.Tensor,
                 P: diffusion.Precision = diffusion.F32) -> torch.Tensor:
    """(T, projection_dim) embeddings of frames (T, H, W, 3) in [0, 1]:
    resized to ``image_size``, normalised by CLIP's mean and std, through
    the tower."""
    x = resize(frames.permute(0, 3, 1, 2).float(), cfg["image_size"])
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return vision_forward(W, cfg, (x - mean) / std, P)


def vision_forward(W: Dict[str, torch.Tensor], cfg: dict, pixels: torch.Tensor,
                   P: diffusion.Precision = diffusion.F32) -> torch.Tensor:
    """image_embeds (B, projection_dim) of normalised pixels (B, 3, S, S)."""
    d, heads, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg.get("layer_norm_eps", 1e-5)
    act = _act(cfg.get("hidden_act", "quick_gelu"))
    p = "vision_model."

    def ln(x, name):
        return F.layer_norm(x, (d,), W[name + ".weight"], W[name + ".bias"], eps)

    b = pixels.shape[0]
    patches = P.conv(pixels, W[p + "embeddings.patch_embedding.weight"], None,
                     stride=cfg["patch_size"]).flatten(2).transpose(1, 2)
    cls = W[p + "embeddings.class_embedding"].expand(b, 1, d)
    x = torch.cat([cls, patches], dim=1) + W[p + "embeddings.position_embedding.weight"][None]
    x = ln(x, p + "pre_layrnorm")
    n = x.shape[1]
    hd = d // heads
    for i in range(cfg["num_hidden_layers"]):
        q_ = f"{p}encoder.layers.{i}."
        h = ln(x, q_ + "layer_norm1")
        q, k, v = (P.linear(h, W[f"{q_}self_attn.{m}_proj.weight"],
                            W[f"{q_}self_attn.{m}_proj.bias"])
                   .reshape(b, n, heads, hd).transpose(1, 2).reshape(b * heads, n, hd)
                   for m in "qkv")
        o = diffusion.attention(P, q, k, v).reshape(b, heads, n, hd).transpose(1, 2)
        x = x + P.linear(o.reshape(b, n, d), W[q_ + "self_attn.out_proj.weight"],
                         W[q_ + "self_attn.out_proj.bias"])
        h = ln(x, q_ + "layer_norm2")
        h = act(P.linear(h, W[q_ + "mlp.fc1.weight"], W[q_ + "mlp.fc1.bias"]))
        x = x + P.linear(h, W[q_ + "mlp.fc2.weight"], W[q_ + "mlp.fc2.bias"])
    pooled = ln(x[:, 0], p + "post_layernorm")
    return P.linear(pooled, W["visual_projection.weight"])


def shapes(cfg: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the tower by its ``transformers`` key, with its
    shape."""
    S: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    d, mlp, ps = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    p = "vision_model."
    S[p + "embeddings.class_embedding"] = (d,)
    S[p + "embeddings.patch_embedding.weight"] = (d, cfg.get("num_channels", 3), ps, ps)
    S[p + "embeddings.position_embedding.weight"] = ((cfg["image_size"] // ps) ** 2 + 1, d)
    S[p + "pre_layrnorm.weight"] = S[p + "pre_layrnorm.bias"] = (d,)
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}encoder.layers.{i}."
        for m in ("k", "v", "q", "out"):
            S[q + f"self_attn.{m}_proj.weight"] = (d, d)
            S[q + f"self_attn.{m}_proj.bias"] = (d,)
        S[q + "layer_norm1.weight"] = S[q + "layer_norm1.bias"] = (d,)
        S[q + "mlp.fc1.weight"], S[q + "mlp.fc1.bias"] = (mlp, d), (mlp,)
        S[q + "mlp.fc2.weight"], S[q + "mlp.fc2.bias"] = (d, mlp), (d,)
        S[q + "layer_norm2.weight"] = S[q + "layer_norm2.bias"] = (d,)
    S[p + "post_layernorm.weight"] = S[p + "post_layernorm.bias"] = (d,)
    S["visual_projection.weight"] = (cfg["projection_dim"], d)
    return S

