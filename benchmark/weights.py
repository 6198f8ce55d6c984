"""Random model weights at a configuration's published widths, drawn on
the device from the run's seed and written in bfloat16 in the layout the
program loads: one directory a sub-model, each a ``config.json`` and the
weights' file (``diffusion_pytorch_model.bin`` unless the kind names
another).  The kind module's ``weight_files`` names the sub-models and
their shapes, in draw order (``kinds/__init__.py``); the text-to-3D kinds
write ``unet/`` and ``vae/``, the VAE's encoder and quant_conv only, all
their step runs.

Convolution and dense weights and their biases are uniform in
+-1 / sqrt(fan_in) (PyTorch's default initialisers), norms are ones and
zeros.  The draw is one large uniform buffer per file, cut into the
tensors, so writing takes a few calls and not one per leaf; every file of
a set comes from one generator.

Two sets per configuration (the seed modulo 2 picks one) live under
``<cache>/weights`` (``benchmark/.cache/weights`` in a run); a set is
written once per checkout, so a check of many seeds writes at most two
sets a configuration."""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import time
from typing import Any, Dict, List, Tuple

import torch

WEIGHT_SETS = 2
CHUNK = 1 << 26  # uniforms per draw call
FILE = "diffusion_pytorch_model.bin"


def set_index(seed: int) -> int:
    return int(seed) % WEIGHT_SETS


def _digest(config: dict, files: List[Dict[str, Any]], index: int) -> str:
    """Of each sub-model's sizes (the configuration's group of its name,
    else its ``config.json`` body) and the set."""
    sizes = {sub["name"]: config.get(sub["name"], sub["config"]) for sub in files}
    text = json.dumps({**sizes, "set": index}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def weight_dir(cache: str, config: dict, seed: int, files: List[Dict[str, Any]]) -> str:
    index = set_index(seed)
    return os.path.join(cache, "weights",
                        f"{config['name']}-set{index}-{_digest(config, files, index)}")


def _draw(shapes, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The tensors of ``shapes`` in bfloat16 on the CPU, cut from one
    uniform buffer drawn on ``device``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        flat[start:start + n] = torch.rand(n, generator=generator, device=device) * 2.0 - 1.0
    out, offset = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if "norm" in key:  # GroupNorm / LayerNorm: scale 1, shift 0
            t.fill_(1.0 if key.endswith("weight") else 0.0)
        else:
            w_shape = shapes[key[: -len("bias")] + "weight"] if key.endswith("bias") else shape
            t.mul_(1.0 / math.sqrt(math.prod(w_shape[1:])))
        out[key] = t
    cpu = flat.cpu()
    offset = 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        out[key] = cpu[offset:offset + n].view(shape)
        offset += n
    return out


def ensure(cache: str, config: dict, seed: int, device,
           files: List[Dict[str, Any]]) -> Tuple[str, float]:
    """The weight directory of (configuration, seed) with the sub-models
    ``files`` (the kind's ``weight_files``): written first when it is not
    complete.  Returns it and the seconds spent writing (0 when it was
    there)."""
    path = weight_dir(cache, config, seed, files)
    if os.path.exists(os.path.join(path, "complete")):
        return path, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(path, ignore_errors=True)
    index = set_index(seed)
    seed_material = f"{config['name']}/{index}".encode()
    gen_seed = int.from_bytes(hashlib.sha256(seed_material).digest()[:8], "little") >> 1
    generator = torch.Generator(device=device).manual_seed(gen_seed)
    for sub in files:
        tensors = _draw(sub["shapes"], generator, device)
        sub_dir = os.path.join(path, sub["name"])
        os.makedirs(sub_dir, exist_ok=True)
        with open(os.path.join(sub_dir, "config.json"), "w") as f:
            json.dump(sub["config"], f, indent=1)
        target = os.path.join(sub_dir, sub.get("file", FILE))
        torch.save(tensors, target + ".part")
        os.replace(target + ".part", target)
        del tensors
    with open(os.path.join(path, "complete"), "w") as f:
        f.write(config["name"])
    # keep the sets of this configuration that the seeds can pick, no others
    parent = os.path.dirname(path)
    keep = {os.path.basename(weight_dir(cache, config, i, files)) for i in range(WEIGHT_SETS)}
    for name in os.listdir(parent):
        if name.startswith(config["name"] + "-set") and name not in keep:
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    return path, time.perf_counter() - t0
