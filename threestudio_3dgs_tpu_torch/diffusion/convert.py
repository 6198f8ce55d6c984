"""Checkpoints for the diffusion modules (the diffusers-side half of the JAX
package's ``diffusion/convert.py``) and the weight carrier from the JAX
package's Flax parameter trees.

  * ``unet_config_from_diffusers_json`` / ``vae_config_from_diffusers_json``
    read a diffusers ``config.json``; ``*_config_to_diffusers`` write one;
  * ``load_torch_state_dict`` reads ``diffusion_pytorch_model.bin`` (or
    ``.safetensors`` where that package is installed); ``load_frozen``
    builds a module from a state dict, frozen on a device in f32;
  * ``cast_half`` casts a module's weights to bf16 and keeps every
    parameter whose name contains "norm" in f32 (``cast_params_half``'s
    name rule); ``fast_model_config`` sets bf16 compute;
  * ``fuse_lora`` fuses a LoRA adapter into a base state dict;
  * ``flax_unet_to_torch`` / ``flax_vae_encoder_to_torch`` /
    ``flax_vae_decoder_to_torch`` turn Flax trees (nested dicts of numpy
    arrays) into diffusers state dicts: the exact inverse of the JAX
    package's ``torch_unet_to_flax`` / ``torch_vae_*_to_flax`` (conv HWIO ->
    OIHW, dense (in, out) -> (out, in), norm ``scale`` -> ``weight``);
  * ``write_random_checkpoint`` writes a seeded random-init checkpoint
    directory in diffusers layout, where real weights drop in unchanged.

The ldm / Zero123 conversions wait for the image-to-3D slice."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict

import numpy as np
import torch

from .unet import UNet2DCondition, UNet2DConditionConfig, SD21_UNET
from .vae import AutoencoderKLConfig, SD_VAE, VAEDecoder, VAEEncoder

# ---------------------------------------------------------------------------
# diffusers config.json
# ---------------------------------------------------------------------------


def unet_config_from_diffusers_json(path: str) -> UNet2DConditionConfig:
    """A diffusers ``unet/config.json`` -> UNet2DConditionConfig."""
    with open(path) as f:
        cfg = json.load(f)
    n = len(cfg["block_out_channels"])
    ahd = cfg.get("attention_head_dim", 8)
    if isinstance(ahd, int):
        ahd = [ahd] * n
    return UNet2DConditionConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        attention_head_dim=tuple(ahd),
        cross_attention_dim=cfg.get("cross_attention_dim", 1280),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        use_linear_projection=cfg.get("use_linear_projection", False),
        freq_shift=cfg.get("freq_shift", 0),
        norm_groups=cfg.get("norm_num_groups", 32),
    )


def vae_config_from_diffusers_json(path: str) -> AutoencoderKLConfig:
    """A diffusers ``vae/config.json`` -> AutoencoderKLConfig."""
    with open(path) as f:
        cfg = json.load(f)
    return AutoencoderKLConfig(
        in_channels=cfg.get("in_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def unet_config_to_diffusers(cfg: UNet2DConditionConfig) -> dict:
    """The fields of a diffusers ``unet/config.json`` for this architecture
    (those of stabilityai/stable-diffusion-2-1-base for SD21_UNET)."""
    return {
        "_class_name": "UNet2DConditionModel",
        "act_fn": "silu",
        "attention_head_dim": list(cfg.attention_head_dim),
        "block_out_channels": list(cfg.block_out_channels),
        "center_input_sample": False,
        "cross_attention_dim": cfg.cross_attention_dim,
        "down_block_types": list(cfg.down_block_types),
        "downsample_padding": 1,
        "flip_sin_to_cos": True,
        "freq_shift": cfg.freq_shift,
        "in_channels": cfg.in_channels,
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": 1,
        "norm_eps": 1e-05,
        "norm_num_groups": cfg.norm_groups,
        "out_channels": cfg.out_channels,
        "up_block_types": list(cfg.up_block_types),
        "use_linear_projection": cfg.use_linear_projection,
    }


def vae_config_to_diffusers(cfg: AutoencoderKLConfig) -> dict:
    """The fields of a diffusers ``vae/config.json`` for this architecture."""
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "act_fn": "silu",
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "in_channels": cfg.in_channels,
        "latent_channels": cfg.latent_channels,
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": cfg.norm_groups,
        "out_channels": cfg.in_channels,
        "scaling_factor": cfg.scaling_factor,
        "up_block_types": ["UpDecoderBlock2D"] * n,
    }


# ---------------------------------------------------------------------------
# State dicts
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.bin`` (torch pickle, loaded with ``weights_only=True``) or
    ``.safetensors`` file -> {key: tensor} on the CPU."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{path}: reading .safetensors needs the safetensors package, which is not "
                "installed; save the weights as diffusion_pytorch_model.bin instead"
            ) from e
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]  # lightning-style nesting
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_frozen(module_cls, model_cfg, state_dict: Dict[str, torch.Tensor],
                device) -> torch.nn.Module:
    """Build a module without initialising it, load the state dict
    strictly and move it to ``device`` in f32, frozen and in eval mode."""
    with torch.device("meta"):
        module = module_cls(model_cfg)
    module.load_state_dict(state_dict, strict=True, assign=True)
    return module.to(device=device, dtype=torch.float32).requires_grad_(False).eval()


def cast_half(module: torch.nn.Module, dtype=torch.bfloat16) -> torch.nn.Module:
    """Cast conv / dense weights to ``dtype`` in place; every parameter whose
    name contains "norm" stays f32 (GroupNorm and LayerNorm statistics run in
    f32 and their epsilons sit below bf16 resolution)."""
    for name, p in module.named_parameters():
        p.data = p.data.float() if "norm" in name else p.data.to(dtype)
    return module


def fast_model_config(model_cfg, half_precision: bool):
    """bf16 compute when ``half_precision`` (the ``half_precision_weights``
    default of the SD guidance).  The JAX package's counterpart also turns
    on the flash attention; here every UNet routes its attention (K5 on the
    card, the einsum elsewhere)."""
    return dataclasses.replace(model_cfg, dtype=torch.bfloat16) if half_precision else model_cfg


_LORA_SUFFIXES = (
    (".lora_A.weight", "down"),
    (".lora_B.weight", "up"),
    (".lora.down.weight", "down"),
    (".lora.up.weight", "up"),
    (".lora_down.weight", "down"),
    (".lora_up.weight", "up"),
    (".alpha", "alpha"),
)


def fuse_lora(base_sd: Dict[str, torch.Tensor], lora_sd: Dict[str, torch.Tensor],
              scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """W' = W + scale * (alpha / rank) * up @ down for every LoRA pair (peft
    ``lora_A/lora_B`` or diffusers ``lora.down/lora.up`` naming; an optional
    ``alpha`` per module), fused once before the weights load."""
    fused = dict(base_sd)
    pairs: Dict[str, dict] = {}
    for key, value in lora_sd.items():
        for suffix, role in _LORA_SUFFIXES:
            if key.endswith(suffix):
                pairs.setdefault(key[: -len(suffix)], {})[role] = torch.as_tensor(value)
                break
    for module, d in pairs.items():
        if "down" not in d or "up" not in d:
            continue
        down, up = d["down"].float(), d["up"].float()
        rank = down.shape[0]
        alpha = float(d.get("alpha", rank))
        target = module + ".weight"
        if target not in fused:
            stripped = target
            for pre in ("base_model.model.", "unet."):
                if stripped.startswith(pre):
                    stripped = stripped[len(pre):]
            if stripped not in fused:
                raise KeyError(f"LoRA target not in base state dict: {target}")
            target = stripped
        w = torch.as_tensor(fused[target]).float()
        delta = (up.reshape(up.shape[0], -1) @ down.reshape(rank, -1)).reshape(w.shape)
        fused[target] = w + scale * (alpha / rank) * delta
    return fused


# ---------------------------------------------------------------------------
# Carrier: the JAX package's Flax trees -> diffusers state dicts
# ---------------------------------------------------------------------------

_TOP = (
    (r"(down|up)_(\d+)_resnet_(\d+)$", r"\1_blocks.\2.resnets.\3"),
    (r"(down|up)_(\d+)_attn_(\d+)$", r"\1_blocks.\2.attentions.\3"),
    (r"down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv"),
    (r"up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0.conv"),
    (r"mid_resnet_(\d+)$", r"mid_block.resnets.\1"),
    (r"mid_attn$", r"mid_block.attentions.0"),
    (r"(time|camera)_embedding_linear_(\d)$", r"\1_embedding.linear_\2"),
)
_SUB = {
    "transformer_blocks_0": "transformer_blocks.0",
    "to_out_0": "to_out.0",
    "ff_proj": "ff.net.0.proj",
    "ff_out": "ff.net.2",
}


def _torch_module_name(path) -> str:
    top = path[0]
    for pattern, repl in _TOP:
        if re.match(pattern, top):
            top = re.sub(pattern, repl, top)
            break
    return ".".join([top] + [_SUB.get(p, p) for p in path[1:]])


def _torch_leaf(leaf: str, value) -> tuple:
    v = np.asarray(value)
    if leaf == "kernel":
        # conv HWIO -> OIHW, dense (in, out) -> (out, in)
        return "weight", (np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T)
    if leaf == "scale":
        return "weight", v
    if leaf == "bias":
        return "bias", v
    raise KeyError(f"unmapped Flax leaf: {leaf}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_to_torch(params, half: str = "", unprefixed=()) -> Dict[str, torch.Tensor]:
    params = params.get("params", params)
    out = {}
    for path, value in _flatten(params):
        *mods, leaf = path
        name, arr = _torch_leaf(leaf, value)
        key = _torch_module_name(tuple(mods)) + "." + name
        if half and mods[0] not in unprefixed:
            key = f"{half}.{key}"
        out[key] = torch.from_numpy(np.array(arr))  # a copy: JAX's host arrays are read-only
    return out


def flax_unet_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax UNet2DCondition tree -> diffusers UNet2DConditionModel state dict
    (inverse of the JAX package's ``torch_unet_to_flax``)."""
    return _flax_to_torch(params)


def flax_vae_encoder_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax VAEEncoder tree -> ``encoder.*`` + ``quant_conv.*`` keys."""
    return _flax_to_torch(params, "encoder", ("quant_conv",))


def flax_vae_decoder_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax VAEDecoder tree -> ``decoder.*`` + ``post_quant_conv.*`` keys."""
    return _flax_to_torch(params, "decoder", ("post_quant_conv",))


# ---------------------------------------------------------------------------
# A random-init checkpoint directory in diffusers layout
# ---------------------------------------------------------------------------


def write_random_checkpoint(root: str, unet_cfg: UNet2DConditionConfig = SD21_UNET,
                            vae_cfg: AutoencoderKLConfig = SD_VAE, seed: int = 0,
                            device="cuda") -> Dict[str, int]:
    """``root/unet`` and ``root/vae``, each a ``config.json`` and a
    ``diffusion_pytorch_model.bin`` of f32 weights drawn by PyTorch's default
    initialisers from ``seed`` on ``device`` (the work done per step does not
    depend on the weight values).  A real checkpoint in the same layout
    replaces it unchanged.  Returns the bytes written per file."""
    device = torch.device(device)
    cards = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cards), torch.device(device):
        torch.manual_seed(seed)
        files = {"unet": (unet_config_to_diffusers(unet_cfg), [UNet2DCondition(unet_cfg)]),
                 "vae": (vae_config_to_diffusers(vae_cfg),
                         [VAEEncoder(vae_cfg), VAEDecoder(vae_cfg)])}
    sizes = {}
    for sub, (cfg_json, modules) in files.items():
        sd = {k: v.to("cpu", torch.float32) for m in modules for k, v in m.state_dict().items()}
        del modules[:]
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg_json, f, indent=2)
        path = os.path.join(root, sub, "diffusion_pytorch_model.bin")
        torch.save(sd, path)
        sizes[path] = os.path.getsize(path)
    return sizes
