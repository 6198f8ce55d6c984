"""Checkpoints of the training state as ``.npz``: the Gaussian field's
params, Adam moments and count, ``alive`` and statistics, the extra
parameters (the neural background's MLP) with their Adam moments and
count, plus the step.  Keys are slash-joined field paths
(``gauss/params/xyz``, ``gauss/adam/mu/xyz``, ``extra/params/background/w0``,
``extra/adam/mu/background/w0``, ...).

A spacetime field's temporal parameters are saved under their own names
(``gauss/params/motion``, ...) and a checkpoint that holds any of them
loads as a spacetime field; the deformation network's parameters are
extra parameters (``extra/params/deformation/grids/0/0``, ...).

A SuGaR state is saved as ``gauss/params/points``, ...,
``gauss/adam/mu/points``, ..., ``gauss/faces``, ``gauss/bary`` and
``gauss/thickness``; a checkpoint that holds ``gauss/faces`` loads as one.
A dynamic SuGaR state adds its node tracks (``gauss/params/node_trans``,
..., with their moments), ``gauss/nodes_xyz``, ``gauss/skin_idx`` and
``gauss/skin_w``, and loads as one where it holds ``gauss/nodes_xyz``.

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
from ..models.gaussian_field import STAT_FIELDS, GaussianParams, GaussianState
from ..models.dynamic_sugar import GRAPH_FIELDS, DynamicSuGaRParams, DynamicSuGaRState
from ..models.optim import AdamState
from ..models.spacetime import TEMPORAL_FIELDS, SpacetimeParams
from ..models.sugar import SuGaRParams, SuGaRState


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
    if state.extra_params:
        def host(flat):
            return {k: v.detach().cpu().numpy() for k, v in flat.items()}

        opt = state.extra_opt
        arrays.update(_flatten({"extra": {
            "params": {g: host(leaves) for g, leaves in state.extra_params.items()},
            "adam": {"mu": host(opt.mu), "nu": host(opt.nu), "count": opt.count},
        }}))
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)


def load_checkpoint_arrays(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """The flat arrays of a checkpoint and its step."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, int(arrays.pop("__step__"))


def _sugar_from_arrays(arrays: Dict[str, np.ndarray], device) -> SuGaRState:
    """A SuGaR state, dynamic where the arrays hold its graph."""
    dynamic = "gauss/nodes_xyz" in arrays
    params_cls, state_cls = ((DynamicSuGaRParams, DynamicSuGaRState) if dynamic
                             else (SuGaRParams, SuGaRState))
    buffers = ("faces", "bary", "thickness") + (GRAPH_FIELDS if dynamic else ())

    def fields(prefix):
        return {k: torch.as_tensor(arrays[f"gauss/{prefix}{k}"], device=device)
                for k in params_cls.FIELDS if f"gauss/{prefix}{k}" in arrays}  # optional ones

    return state_cls(
        params=params_cls(**fields("params/")),
        adam=AdamState(mu=fields("adam/mu/"), nu=fields("adam/nu/"),
                       count=int(arrays["gauss/adam/count"])),
        **{k: torch.as_tensor(arrays[f"gauss/{k}"], device=device) for k in buffers},
    )


def _gauss_from_arrays(arrays: Dict[str, np.ndarray], device) -> Any:
    """The field of a checkpoint: a SuGaR state where it has faces, a
    spacetime field where it has any temporal parameter."""
    if "gauss/faces" in arrays:
        return _sugar_from_arrays(arrays, device)
    temporal = any(f"gauss/params/{k}" in arrays for k in TEMPORAL_FIELDS)
    params_cls = SpacetimeParams if temporal else GaussianParams

    def fields(prefix):
        return {k: torch.as_tensor(arrays[f"gauss/{prefix}{k}"], device=device)
                for k in params_cls.FIELDS if f"gauss/{prefix}{k}" in arrays}  # optional ones

    return GaussianState(
        params=params_cls(**fields("params/")),
        adam=AdamState(mu=fields("adam/mu/"), nu=fields("adam/nu/"),
                       count=int(arrays["gauss/adam/count"])),
        alive=torch.as_tensor(arrays["gauss/alive"], device=device),
        **{k: torch.as_tensor(arrays[f"gauss/{k}"], device=device) for k in STAT_FIELDS},
    )


def load_checkpoint(path: str, device="cuda") -> Tuple[Any, int]:
    """The ``SystemState`` a port checkpoint holds (the field, and the
    extra parameters with their Adam state where it has them), on `device`,
    and its step."""
    from ..systems.base import SystemState, unflatten_extra

    arrays, step = load_checkpoint_arrays(path)

    def extra(prefix):
        return {k[len(prefix):]: torch.as_tensor(v, device=device)
                for k, v in arrays.items() if k.startswith(prefix)}

    extra_params = unflatten_extra(extra("extra/params/"))
    extra_opt = AdamState(mu=extra("extra/adam/mu/"), nu=extra("extra/adam/nu/"),
                          count=int(arrays["extra/adam/count"])) if extra_params else None
    return SystemState(gauss=_gauss_from_arrays(arrays, device), extra_params=extra_params,
                       extra_opt=extra_opt), step
