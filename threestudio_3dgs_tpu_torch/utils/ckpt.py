"""Checkpoints of the training state as ``.npz``: the Gaussian field's
params, Adam moments and count, ``alive`` and statistics, plus the step.
Keys are slash-joined field paths (``params/xyz``, ``adam/mu/xyz``, ...).

``load_checkpoint`` reads the port's own files only.  A JAX package
checkpoint stores its leaves by position beside a pickled JAX treedef,
which cannot be read without JAX; ``models/convert.py`` carries a state
across packages instead."""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.convert import to_numpy
from ..models.gaussian_field import PARAM_FIELDS, STAT_FIELDS, GaussianParams, GaussianState
from ..models.optim import AdamState


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_checkpoint(path: str, state: Any, step: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten({"gauss": to_numpy(state.gauss)})
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)


def load_checkpoint_arrays(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """The flat arrays of a checkpoint and its step."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, int(arrays.pop("__step__"))


def load_checkpoint(path: str, device="cuda") -> Tuple[GaussianState, int]:
    """The Gaussian-field state a port checkpoint holds, on `device`, and
    its step."""
    arrays, step = load_checkpoint_arrays(path)

    def fields(prefix):
        return {k: torch.as_tensor(arrays[f"gauss/{prefix}{k}"], device=device)
                for k in PARAM_FIELDS if f"gauss/{prefix}{k}" in arrays}  # normal is optional

    state = GaussianState(
        params=GaussianParams(**fields("params/")),
        adam=AdamState(mu=fields("adam/mu/"), nu=fields("adam/nu/"),
                       count=int(arrays["gauss/adam/count"])),
        alive=torch.as_tensor(arrays["gauss/alive"], device=device),
        **{k: torch.as_tensor(arrays[f"gauss/{k}"], device=device) for k in STAT_FIELDS},
    )
    return state, step
