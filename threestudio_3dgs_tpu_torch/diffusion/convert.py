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
    directory in diffusers layout, where real weights drop in unchanged;
  * the CompVis/ldm single-file format of Zero123 / Stable Zero123
    (``stable_zero123.ckpt``: the UNet under ``model.diffusion_model.``,
    the VAE under ``first_stage_model.``, ``cc_projection``):
    ``ldm_unet_to_diffusers`` / ``ldm_vae_encoder_to_diffusers`` rename
    its keys to diffusers', ``is_ldm_state_dict`` recognises it,
    ``infer_unet_config_from_state_dict`` /
    ``infer_vae_config_from_state_dict`` read an architecture off the
    shapes (a copy of the JAX package's functions, which this package may
    not import); ``write_random_ldm_checkpoint`` writes a seeded random one
    through the inverse renames."""

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
    """A ``.bin`` or ``.ckpt`` (torch pickle, loaded with
    ``weights_only=True``) or ``.safetensors`` file -> {key: tensor} on the
    CPU.  A Lightning ``.ckpt`` nests its tensors under ``"state_dict"``
    beside non-tensor entries (``global_step``, ``epoch``, ...), which are
    dropped, as is every non-tensor value inside."""
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


def load_frozen(module_cls, model_cfg, state_dict: Dict[str, torch.Tensor], device,
                half: bool = False) -> torch.nn.Module:
    """Build a module without initialising it, load the state dict
    strictly and move it to ``device`` in f32, frozen and in eval mode;
    with ``half`` (the guidances' ``half_precision_weights``) then cast to
    bf16 with f32 norms."""
    with torch.device("meta"):
        module = module_cls(model_cfg)
    module.load_state_dict(state_dict, strict=True, assign=True)
    module = module.to(device=device, dtype=torch.float32).requires_grad_(False).eval()
    return cast_half(module) if half else module


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


# ---------------------------------------------------------------------------
# The CompVis/ldm single-file format (Zero123, Stable Zero123)
# ---------------------------------------------------------------------------

_LDM_RESNET = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_LDM_UNET_ROOTS = ("time_embed.", "input_blocks.", "middle_block.", "output_blocks.", "out.")
_LDM_UNET_PREFIX = "model.diffusion_model."
_LDM_VAE_PREFIX = "first_stage_model."
_LDM_VAE_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}


def _map_resnet(rest: str, table: Dict[str, str], what: str) -> str:
    for src, dst in table.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    raise KeyError(f"unmapped {what} resnet subkey: {rest}")


def ldm_unet_to_diffusers(sd: Dict[str, torch.Tensor], num_res_blocks: int = 2,
                          num_levels: int = 4) -> Dict[str, torch.Tensor]:
    """A CompVis/ldm UNetModel state dict -> diffusers UNet2DConditionModel
    key naming (diffusers' convert_from_ckpt mapping):

      time_embed.0/2                 -> time_embedding.linear_1/linear_2
      input_blocks.0.0               -> conv_in
      input_blocks.{3i+j+1}.0        -> down_blocks.{i}.resnets.{j}
      input_blocks.{3i+j+1}.1        -> down_blocks.{i}.attentions.{j}
      input_blocks.{3(i+1)}.0.op     -> down_blocks.{i}.downsamplers.0.conv
      middle_block.{0,2}             -> mid_block.resnets.{0,1}
      middle_block.1                 -> mid_block.attentions.0
      output_blocks.{ki+j}.0         -> up_blocks.{i}.resnets.{j}   (k = nres + 1)
      output_blocks.{ki+j}.1         -> up_blocks.{i}.attentions.{j} (if attn)
      output_blocks.{...}.{1|2}.conv -> up_blocks.{i}.upsamplers.0.conv
      out.0 / out.2                  -> conv_norm_out / conv_out

    with the resnet subkeys in_layers.0 -> norm1, in_layers.2 -> conv1,
    emb_layers.1 -> time_emb_proj, out_layers.0 -> norm2, out_layers.3 ->
    conv2, skip_connection -> conv_shortcut; the SpatialTransformer
    subkeys already have diffusers' names.  Keys outside the UNet (the
    VAE, the CLIP tower, ``model_ema.*``, the schedule buffers) are
    dropped; ``num_levels`` is read by nothing, as in the JAX package."""
    k = num_res_blocks + 1
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        had_prefix = False
        for pre in (_LDM_UNET_PREFIX, "diffusion_model."):
            if key.startswith(pre):
                key, had_prefix = key[len(pre):], True
                break
        if not had_prefix and not key.startswith(_LDM_UNET_ROOTS):
            continue
        if (m := re.match(r"time_embed\.(0|2)\.(weight|bias)$", key)):
            out[f"time_embedding.linear_{1 if m.group(1) == '0' else 2}.{m.group(2)}"] = value
        elif (m := re.match(r"input_blocks\.0\.0\.(weight|bias)$", key)):
            out[f"conv_in.{m.group(1)}"] = value
        elif (m := re.match(r"input_blocks\.(\d+)\.0\.op\.(weight|bias)$", key)):
            out[f"down_blocks.{int(m.group(1)) // k - 1}.downsamplers.0.conv.{m.group(2)}"] = value
        elif (m := re.match(r"input_blocks\.(\d+)\.(0|1)\.(.*)$", key)):
            level, j = divmod(int(m.group(1)) - 1, k)
            if m.group(2) == "0":
                out[f"down_blocks.{level}.resnets.{j}."
                    + _map_resnet(m.group(3), _LDM_RESNET, "ldm")] = value
            else:
                out[f"down_blocks.{level}.attentions.{j}.{m.group(3)}"] = value
        elif (m := re.match(r"middle_block\.(0|2)\.(.*)$", key)):
            j = 0 if m.group(1) == "0" else 1
            out[f"mid_block.resnets.{j}." + _map_resnet(m.group(2), _LDM_RESNET, "ldm")] = value
        elif (m := re.match(r"middle_block\.1\.(.*)$", key)):
            out[f"mid_block.attentions.0.{m.group(1)}"] = value
        elif (m := re.match(r"output_blocks\.(\d+)\.(\d)\.conv\.(weight|bias)$", key)):
            out[f"up_blocks.{int(m.group(1)) // k}.upsamplers.0.conv.{m.group(3)}"] = value
        elif (m := re.match(r"output_blocks\.(\d+)\.(0|1)\.(.*)$", key)):
            level, j = divmod(int(m.group(1)), k)
            if m.group(2) == "0":
                out[f"up_blocks.{level}.resnets.{j}."
                    + _map_resnet(m.group(3), _LDM_RESNET, "ldm")] = value
            else:
                out[f"up_blocks.{level}.attentions.{j}.{m.group(3)}"] = value
        elif (m := re.match(r"out\.(0|2)\.(weight|bias)$", key)):
            name = "conv_norm_out" if m.group(1) == "0" else "conv_out"
            out[f"{name}.{m.group(2)}"] = value
        else:
            raise KeyError(f"unmapped ldm UNet key: {key}")
    return out


def ldm_vae_encoder_to_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The CompVis/ldm AutoencoderKL encoder keys
    (``first_stage_model.encoder.*``, ``quant_conv``) -> diffusers naming:
    ``down.{i}.block.{j}`` -> ``down_blocks.{i}.resnets.{j}``
    (``nin_shortcut`` -> ``conv_shortcut``), ``down.{i}.downsample`` ->
    ``down_blocks.{i}.downsamplers.0``, ``mid.block_{1,2}`` / ``mid.attn_1``
    -> ``mid_block.resnets.{0,1}`` / ``mid_block.attentions.0``,
    ``norm_out`` -> ``conv_norm_out``; the attention's q / k / v /
    proj_out are 1x1 convolutions in ldm and linear layers in diffusers,
    so their (C, C, 1, 1) weights become (C, C).  Other keys are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.startswith(_LDM_VAE_PREFIX):
            key = key[len(_LDM_VAE_PREFIX):]
        if key.startswith("quant_conv."):
            out[key] = value
            continue
        if not key.startswith("encoder."):
            continue
        rest = key[len("encoder."):]
        if (m := re.match(r"(conv_in|conv_out)\.(weight|bias)$", rest)):
            out[f"encoder.{m.group(1)}.{m.group(2)}"] = value
        elif (m := re.match(r"norm_out\.(weight|bias)$", rest)):
            out[f"encoder.conv_norm_out.{m.group(1)}"] = value
        elif (m := re.match(
                r"down\.(\d+)\.block\.(\d+)\.(norm1|conv1|norm2|conv2|nin_shortcut)\."
                r"(weight|bias)$", rest)):
            name = "conv_shortcut" if m.group(3) == "nin_shortcut" else m.group(3)
            key = f"encoder.down_blocks.{m.group(1)}.resnets.{m.group(2)}.{name}.{m.group(4)}"
            out[key] = value
        elif (m := re.match(r"down\.(\d+)\.downsample\.conv\.(weight|bias)$", rest)):
            out[f"encoder.down_blocks.{m.group(1)}.downsamplers.0.conv.{m.group(2)}"] = value
        elif (m := re.match(r"mid\.block_([12])\.(.*)$", rest)):
            sub = m.group(2).replace("nin_shortcut.", "conv_shortcut.")
            out[f"encoder.mid_block.resnets.{int(m.group(1)) - 1}.{sub}"] = value
        elif (m := re.match(r"mid\.attn_1\.norm\.(weight|bias)$", rest)):
            out[f"encoder.mid_block.attentions.0.group_norm.{m.group(1)}"] = value
        elif (m := re.match(r"mid\.attn_1\.(q|k|v|proj_out)\.(weight|bias)$", rest)):
            if m.group(2) == "weight" and value.dim() == 4:
                value = value[:, :, 0, 0]  # 1x1 conv -> linear
            out[f"encoder.mid_block.attentions.0.{_LDM_VAE_ATTN[m.group(1)]}.{m.group(2)}"] = value
        else:
            raise KeyError(f"unmapped ldm VAE encoder key: {key}")
    return out


def is_ldm_state_dict(sd: Dict[str, torch.Tensor]) -> bool:
    """Whether the dict carries CompVis/ldm UNet naming rather than
    diffusers'."""
    return any(k.startswith(("model.diffusion_model.", "diffusion_model.", "input_blocks."))
               for k in sd)


def _shape(t) -> tuple:
    return tuple(t.shape)


def infer_unet_config_from_state_dict(sd: Dict[str, torch.Tensor],
                                      base=None) -> UNet2DConditionConfig:
    """A UNet2DConditionConfig read off a diffusers-naming state dict's
    shapes (block channels, in / out channels, cross-attention width, block
    types, layers per block, linear or 1x1-conv projections).  Head counts
    and norm groups come from ``base`` (default ZERO123_UNET), each head
    count set to 1 where it does not divide its level's channels and the
    group count halved until it divides them all: checkpoints do not encode
    them."""
    from .unet import ZERO123_UNET

    base = base or ZERO123_UNET
    chans = []
    while f"down_blocks.{len(chans)}.resnets.0.conv1.weight" in sd:
        chans.append(_shape(sd[f"down_blocks.{len(chans)}.resnets.0.conv1.weight"])[0])
    n = len(chans)
    layers = 0
    while f"down_blocks.0.resnets.{layers}.conv1.weight" in sd:
        layers += 1
    cross, use_linear = base.cross_attention_dim, base.use_linear_projection
    down_types, up_types = [], []
    for i in range(n):
        has = f"down_blocks.{i}.attentions.0.norm.weight" in sd
        down_types.append("CrossAttnDownBlock2D" if has else "DownBlock2D")
        k = f"down_blocks.{i}.attentions.0.transformer_blocks.0.attn2.to_k.weight"
        if k in sd:
            cross = _shape(sd[k])[1]
        pk = f"down_blocks.{i}.attentions.0.proj_in.weight"
        if pk in sd:
            use_linear = len(_shape(sd[pk])) == 2
    for i in range(n):
        has = f"up_blocks.{i}.attentions.0.norm.weight" in sd
        up_types.append("CrossAttnUpBlock2D" if has else "UpBlock2D")
    heads = list(base.attention_head_dim[:n]) + [8] * max(0, n - len(base.attention_head_dim))
    heads = tuple(h if c % h == 0 else 1 for h, c in zip(heads, chans))
    ng = base.norm_groups
    while ng > 1 and any(c % ng for c in chans):
        ng //= 2
    return dataclasses.replace(
        base,
        in_channels=_shape(sd["conv_in.weight"])[1],
        out_channels=_shape(sd["conv_out.weight"])[0],
        block_out_channels=tuple(chans),
        layers_per_block=layers,
        attention_head_dim=heads,
        cross_attention_dim=cross,
        down_block_types=tuple(down_types),
        up_block_types=tuple(up_types),
        use_linear_projection=use_linear,
        norm_groups=ng,
    )


def infer_vae_config_from_state_dict(sd: Dict[str, torch.Tensor],
                                     base=None) -> AutoencoderKLConfig:
    """An AutoencoderKLConfig read off a diffusers-naming encoder state
    dict's shapes (the rest from ``base``, default SD_VAE)."""
    base = base or SD_VAE
    chans = []
    while f"encoder.down_blocks.{len(chans)}.resnets.0.conv1.weight" in sd:
        chans.append(_shape(sd[f"encoder.down_blocks.{len(chans)}.resnets.0.conv1.weight"])[0])
    layers = 0
    while f"encoder.down_blocks.0.resnets.{layers}.conv1.weight" in sd:
        layers += 1
    ng = base.norm_groups
    while ng > 1 and any(c % ng for c in chans):
        ng //= 2
    return dataclasses.replace(
        base,
        in_channels=_shape(sd["encoder.conv_in.weight"])[1],
        latent_channels=_shape(sd["quant_conv.weight"])[0] // 2,
        block_out_channels=tuple(chans),
        layers_per_block=layers,
        norm_groups=ng,
    )


def diffusers_unet_to_ldm(sd: Dict[str, torch.Tensor],
                          cfg: UNet2DConditionConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``ldm_unet_to_diffusers`` for a UNet of ``cfg``
    (whose up blocks with attention put their upsampler third), the keys
    under ``model.diffusion_model.``."""
    k = cfg.layers_per_block + 1
    inv_res = {v: key for key, v in _LDM_RESNET.items()}
    out = {}
    for key, value in sd.items():
        if (m := re.match(r"time_embedding\.linear_([12])\.(.*)$", key)):
            new = f"time_embed.{0 if m.group(1) == '1' else 2}.{m.group(2)}"
        elif key.startswith("conv_in."):
            new = "input_blocks.0.0." + key[len("conv_in."):]
        elif (m := re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", key)):
            n = k * int(m.group(1)) + int(m.group(2)) + 1
            new = f"input_blocks.{n}.0." + _map_resnet(m.group(3), inv_res, "diffusers")
        elif (m := re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.*)$", key)):
            new = f"input_blocks.{k * int(m.group(1)) + int(m.group(2)) + 1}.1.{m.group(3)}"
        elif (m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", key)):
            new = f"input_blocks.{k * (int(m.group(1)) + 1)}.0.op.{m.group(2)}"
        elif (m := re.match(r"mid_block\.resnets\.([01])\.(.*)$", key)):
            new = (f"middle_block.{2 * int(m.group(1))}."
                   + _map_resnet(m.group(2), inv_res, "diffusers"))
        elif key.startswith("mid_block.attentions.0."):
            new = "middle_block.1." + key[len("mid_block.attentions.0."):]
        elif (m := re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", key)):
            n = k * int(m.group(1)) + int(m.group(2))
            new = f"output_blocks.{n}.0." + _map_resnet(m.group(3), inv_res, "diffusers")
        elif (m := re.match(r"up_blocks\.(\d+)\.attentions\.(\d+)\.(.*)$", key)):
            new = f"output_blocks.{k * int(m.group(1)) + int(m.group(2))}.1.{m.group(3)}"
        elif (m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", key)):
            level = int(m.group(1))
            sub = 2 if cfg.up_block_types[level].startswith("CrossAttn") else 1
            new = f"output_blocks.{k * level + k - 1}.{sub}.conv.{m.group(2)}"
        elif (m := re.match(r"(conv_norm_out|conv_out)\.(.*)$", key)):
            new = f"out.{0 if m.group(1) == 'conv_norm_out' else 2}.{m.group(2)}"
        else:
            raise KeyError(f"no ldm name for UNet key {key}")
        out[_LDM_UNET_PREFIX + new] = value
    return out


def diffusers_vae_encoder_to_ldm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``ldm_vae_encoder_to_diffusers``, the keys under
    ``first_stage_model.`` (the attention's linear weights as 1x1 convs)."""
    inv_attn = {v: key for key, v in _LDM_VAE_ATTN.items()}
    out = {}
    for key, value in sd.items():
        if key.startswith("quant_conv."):
            new = key
        elif (m := re.match(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(.*)$", key)):
            name = "nin_shortcut" if m.group(3) == "conv_shortcut" else m.group(3)
            new = f"encoder.down.{m.group(1)}.block.{m.group(2)}.{name}.{m.group(4)}"
        elif (m := re.match(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", key)):
            new = f"encoder.down.{m.group(1)}.downsample.conv.{m.group(2)}"
        elif (m := re.match(r"encoder\.mid_block\.resnets\.([01])\.(.*)$", key)):
            sub = m.group(2).replace("conv_shortcut.", "nin_shortcut.")
            new = f"encoder.mid.block_{int(m.group(1)) + 1}.{sub}"
        elif (m := re.match(r"encoder\.mid_block\.attentions\.0\.group_norm\.(.*)$", key)):
            new = f"encoder.mid.attn_1.norm.{m.group(1)}"
        elif (m := re.match(r"encoder\.mid_block\.attentions\.0\.(to_q|to_k|to_v|to_out\.0)\."
                            r"(weight|bias)$", key)):
            new = f"encoder.mid.attn_1.{inv_attn[m.group(1)]}.{m.group(2)}"
            if m.group(2) == "weight":
                value = value[:, :, None, None]
        elif key.startswith("encoder.conv_norm_out."):
            new = "encoder.norm_out." + key[len("encoder.conv_norm_out."):]
        elif key.startswith(("encoder.conv_in.", "encoder.conv_out.")):
            new = key
        else:
            raise KeyError(f"no ldm name for VAE encoder key {key}")
        out[_LDM_VAE_PREFIX + new] = value
    return out


def write_random_ldm_checkpoint(path: str, unet_cfg: UNet2DConditionConfig,
                                vae_cfg: AutoencoderKLConfig = SD_VAE, clip_dim: int = 768,
                                seed: int = 0, device="cuda", dtype=torch.float32) -> int:
    """A CompVis/ldm single-file checkpoint at ``path`` in Stable Zero123's
    layout: a Lightning dict whose ``"state_dict"`` holds the UNet
    (``model.diffusion_model.*``), the VAE encoder and ``quant_conv``
    (``first_stage_model.*``), ``cc_projection`` ((clip_dim + 4) ->
    clip_dim) and the buffers and scalars a real one carries beside them
    (``betas``, ``model_ema.decay``; ``global_step`` and ``epoch`` outside
    it).  Weights are drawn by PyTorch's default initialisers from ``seed``
    on ``device`` and stored in ``dtype``.  Returns the file's bytes."""
    device = torch.device(device)
    cards = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cards), torch.device(device):
        torch.manual_seed(seed)
        unet = UNet2DCondition(unet_cfg)
        enc = VAEEncoder(vae_cfg)
        cc = torch.nn.Linear(clip_dim + 4, clip_dim)

    def host(module):
        return {k: v.to("cpu", dtype) for k, v in module.state_dict().items()}

    state = diffusers_unet_to_ldm(host(unet), unet_cfg)
    del unet
    state.update(diffusers_vae_encoder_to_ldm(host(enc)))
    del enc
    state.update({f"cc_projection.{k}": v for k, v in host(cc).items()})
    state["betas"] = torch.linspace(0.00085**0.5, 0.012**0.5, 1000, dtype=torch.float64) ** 2
    state["model_ema.decay"] = torch.tensor(0.9999)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": state, "global_step": 105000, "epoch": 3}, path)
    return os.path.getsize(path)
