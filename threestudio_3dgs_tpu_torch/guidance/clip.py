"""The CLIP text encoder and image tower, written out as plain
``nn.Module``s: what ``transformers.CLIPTextModel(ids)[0]`` returns, the
last hidden state after ``final_layer_norm``, (77, D), which the JAX
package computes once per prompt variant (``guidance/base.py``
``_clip_encode_local``); and what
``transformers.CLIPVisionModelWithProjection(pixels).image_embeds``
returns, the projected class token, which the JAX Zero123 guidance
computes once per conditioning frame (``guidance/temporal_zero123.py``
``_clip_image_encode_local``).

  * token + position embeddings;
  * pre-LN blocks: causal multi-head self-attention (q, k, v, out
    projections with biases, scale d^-1/2, f32 softmax), then the MLP
    fc1 -> ``hidden_act`` -> fc2, each with a residual;
  * ``hidden_act`` from ``config.json``: ``gelu`` (exact, SD 2.x's
    OpenCLIP encoder) or ``quick_gelu`` (x * sigmoid(1.702 x), SD 1.x's).

The image tower (:class:`CLIPVisionModelWithProjection`): the patch
convolution (no bias), the class embedding and the position embedding,
``pre_layrnorm`` (the checkpoint's spelling), the same pre-LN blocks
without a mask, ``post_layernorm`` of the class token and
``visual_projection`` (no bias).  :class:`ImageEncoder` resizes frames as
``jax.image.resize(..., "bilinear")`` does (antialiased when shrinking)
and normalises them with CLIP's mean and std first.

At 77 tokens (257 for ViT-L/14 at 224^2) the self-attention is below K5's
routing threshold, and the JAX package runs it in torch outside any
kernel, so it is a plain matmul and softmax here too.  Weights come from
``text_encoder/`` (``image_encoder/``):
``pytorch_model.bin`` (``torch.load(weights_only=True)``) or
``model.safetensors`` through :func:`read_safetensors`, a reader of that
format's documented layout (the card's machine has no ``safetensors``
package).  Parameter names are ``transformers``', so a real checkpoint
loads strictly.  :class:`PromptEncoder` loads a directory's tokenizer and
encoder once, for a prompt and its view variants."""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .tokenizer import CLIPTokenizer


@dataclasses.dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


# stabilityai/stable-diffusion-2-1-base text_encoder/config.json (OpenCLIP
# ViT-H/14's text tower without its last block)
SD21_TEXT_ENCODER = CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=23,
                                   num_attention_heads=16, hidden_act="gelu")


def config_from_json(path: str) -> CLIPTextConfig:
    with open(path) as f:
        data = json.load(f)
    data = data.get("text_config", data)
    known = {f.name for f in dataclasses.fields(CLIPTextConfig)}
    return CLIPTextConfig(**{k: v for k, v in data.items() if k in known})


def config_to_json(cfg: CLIPTextConfig) -> dict:
    return {"architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
            "torch_dtype": "float32", **dataclasses.asdict(cfg)}


def _activation(name: str):
    if name == "gelu":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"CLIP hidden_act {name!r} is not supported (gelu, quick_gelu)")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x, mask):
        b, n, d = x.shape
        h = self.heads

        def split(t):
            return t.reshape(b, n, h, d // h).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (d // h) ** -0.5 + mask
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _activation(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids):
        x = self.embeddings(ids)
        n = ids.shape[1]
        mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """forward(ids (B, L) int64) -> last hidden state (B, L, D)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: tensor} on the CPU.  The format: an
    8-byte little-endian header length, a JSON header {name: {"dtype",
    "shape", "data_offsets": [begin, end]}} (plus "__metadata__"), then the
    byte buffer the offsets index."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        if end > len(buf) or begin > end:
            raise ValueError(f"{path}: tensor {name} lies outside the file's buffer")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        if end > begin:
            t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                 offset=begin)
        else:
            t = torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def load_clip_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    """The weights of a ``text_encoder/`` or ``image_encoder/`` directory: ``pytorch_model.bin``
    first, else ``model.safetensors``; raises when it holds neither."""
    bin_path = os.path.join(directory, "pytorch_model.bin")
    st_path = os.path.join(directory, "model.safetensors")
    if os.path.isfile(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.isfile(st_path):
        sd = read_safetensors(st_path)
    else:
        raise FileNotFoundError(
            f"{directory} holds neither pytorch_model.bin nor model.safetensors")
    return {k: v for k, v in sd.items() if not k.endswith("position_ids")}


def load_text_encoder(directory: str, device) -> CLIPTextModel:
    """The text encoder of a ``text_encoder/`` directory, f32 on ``device``,
    its weights loaded strictly."""
    cfg = config_from_json(os.path.join(directory, "config.json"))
    with torch.device("meta"):
        model = CLIPTextModel(cfg)
    model.load_state_dict(load_clip_state_dict(directory), strict=True, assign=True)
    return model.to(device=device, dtype=torch.float32).requires_grad_(False).eval()


def has_clip(model_dir: str) -> bool:
    """Whether ``model_dir`` holds both ``text_encoder/`` and ``tokenizer/``."""
    return bool(model_dir) and all(
        os.path.isdir(os.path.join(model_dir, sub)) for sub in ("text_encoder", "tokenizer"))


class PromptEncoder:
    """The tokenizer and text encoder of a directory (``text_encoder/`` +
    ``tokenizer/``), loaded once, the encoder in f32 on ``device``:
    ``encoder(prompt)`` -> (77, D) f32 hidden states on the host."""

    def __init__(self, model_dir: str, device="cpu"):
        self.device = torch.device(device)
        self.tokenizer = CLIPTokenizer(os.path.join(model_dir, "tokenizer"))
        self.model = load_text_encoder(os.path.join(model_dir, "text_encoder"), self.device)

    def __call__(self, prompt: str) -> np.ndarray:
        ids = torch.tensor([self.tokenizer(prompt)], dtype=torch.int64, device=self.device)
        with torch.no_grad():
            return self.model(ids)[0].cpu().numpy()


def write_random_text_encoder(directory: str, cfg: CLIPTextConfig = SD21_TEXT_ENCODER,
                              seed: int = 0, device="cpu") -> int:
    """``directory/config.json`` and ``pytorch_model.bin`` of f32 weights
    drawn by PyTorch's default initialisers from ``seed`` on ``device``;
    returns the bytes of the weights file."""
    device = torch.device(device)
    cards = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cards), torch.device(device):
        torch.manual_seed(seed)
        model = CLIPTextModel(cfg)
    sd = {k: v.to("cpu", torch.float32) for k, v in model.state_dict().items()}
    del model
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config_to_json(cfg), f, indent=2)
    path = os.path.join(directory, "pytorch_model.bin")
    torch.save(sd, path)
    return os.path.getsize(path)


# ---------------------------------------------------------------------------
# The image tower
# ---------------------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    projection_dim: int = 512
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


# openai/clip-vit-large-patch14's vision tower: the image_encoder/ of the
# Zero123 diffusers ports (224^2, 24 layers of 1024, projection 768)
VIT_L14 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, projection_dim=768,
                           num_hidden_layers=24, num_attention_heads=16, patch_size=14)


def vision_config_from_json(path: str) -> CLIPVisionConfig:
    """An ``image_encoder/config.json`` (a CLIPVisionConfig, or a full
    CLIPConfig's ``vision_config`` with its ``projection_dim``)."""
    with open(path) as f:
        data = json.load(f)
    if "vision_config" in data:
        data = dict(data["vision_config"], projection_dim=data.get(
            "projection_dim", data["vision_config"].get("projection_dim", 512)))
    known = {f.name for f in dataclasses.fields(CLIPVisionConfig)}
    return CLIPVisionConfig(**{k: v for k, v in data.items() if k in known})


def vision_config_to_json(cfg: CLIPVisionConfig) -> dict:
    return {"architectures": ["CLIPVisionModelWithProjection"], "model_type": "clip_vision_model",
            "torch_dtype": "float32", **dataclasses.asdict(cfg)}


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, d)

    def forward(self, pixels):
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)  # (B, P, D)
        cls = self.class_embedding.expand(pixels.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x, 0.0)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(nn.Module):
    """forward(pixels (B, 3, S, S), normalised) -> image_embeds (B, P)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixels):
        return self.visual_projection(self.vision_model(pixels))


def load_image_encoder(directory: str, device) -> CLIPVisionModelWithProjection:
    """The image tower of an ``image_encoder/`` directory, f32 on
    ``device``, its weights loaded strictly (raises on any mismatch)."""
    cfg = vision_config_from_json(os.path.join(directory, "config.json"))
    with torch.device("meta"):
        model = CLIPVisionModelWithProjection(cfg)
    model.load_state_dict(load_clip_state_dict(directory), strict=True, assign=True)
    return model.to(device=device, dtype=torch.float32).requires_grad_(False).eval()


class ImageEncoder:
    """The image tower of a directory, loaded once, f32 on ``device``:
    ``encoder(frames (T, H, W, 3) in [0, 1])`` -> (T, projection_dim) f32
    projected embeddings on the host."""

    def __init__(self, directory: str, device="cpu"):
        self.device = torch.device(device)
        self.model = load_image_encoder(directory, self.device)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        from .mvdream import resize_bilinear

        size = self.model.cfg.image_size
        x = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        x = resize_bilinear(x.permute(0, 3, 1, 2), size)
        mean = torch.tensor(CLIP_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=self.device)[:, None, None]
        with torch.no_grad():
            return self.model((x - mean) / std).cpu().numpy()


def write_random_image_encoder(directory: str, cfg: CLIPVisionConfig = VIT_L14, seed: int = 0,
                               device="cpu") -> int:
    """``directory/config.json`` and ``pytorch_model.bin`` of f32 weights
    drawn by PyTorch's default initialisers from ``seed`` on ``device`` (the
    class and position embeddings standard normal times 0.02); returns the
    bytes of the weights file."""
    device = torch.device(device)
    cards = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cards), torch.device(device):
        torch.manual_seed(seed)
        model = CLIPVisionModelWithProjection(cfg)
        emb = model.vision_model.embeddings
        with torch.no_grad():
            emb.class_embedding.normal_(0.0, 0.02)
            emb.position_embedding.weight.normal_(0.0, 0.02)
    sd = {k: v.to("cpu", torch.float32) for k, v in model.state_dict().items()}
    del model
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(vision_config_to_json(cfg), f, indent=2)
    path = os.path.join(directory, "pytorch_model.bin")
    torch.save(sd, path)
    return os.path.getsize(path)
