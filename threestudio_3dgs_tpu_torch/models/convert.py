"""Carry a training state across packages.

``gaussian_state_from_numpy`` turns a JAX package ``GaussianState`` whose
leaves were brought to the host (``jax.device_get``: numpy leaves) into the
port's state; ``to_numpy`` is its inverse for comparisons.
A JAX ``SpacetimeParams`` field becomes the port's ``SpacetimeParams``.
``extra_from_numpy`` does the same for a JAX ``SystemState``'s
``extra_params`` and ``extra_opt`` (the neural background's MLP, the
deformation network's nested tree, and their Adam moments, flattened to
slash-joined names), which the port cannot draw itself: the JAX package
draws them from a JAX PRNG.  ``sugar_state_from_numpy`` carries a JAX
``SuGaRState`` (the mesh-bound params, their Adam moments and count, the
faces, the barycentric table and the thickness), and
``dynamic_sugar_state_from_numpy`` a JAX ``DynamicSuGaRState`` (those, the
node tracks and their moments, the rest node positions and the skinning
tables).  Only attribute access is used, so nothing of the JAX package is
imported here."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .gaussian_field import STAT_FIELDS, GaussianParams, GaussianState
from .optim import AdamState
from .spacetime import TEMPORAL_FIELDS, SpacetimeParams
from .dynamic_sugar import GRAPH_FIELDS, DynamicSuGaRParams, DynamicSuGaRState
from .sugar import SuGaRParams, SuGaRState


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested tree of dicts and lists -> {slash-joined path: leaf}, e.g. a
    JAX deformation tree -> the port's ``grids/0/0``, ``trunk/0/w``, ..."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Any] = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in flatten_tree(tree, prefix).items()}


def extra_from_numpy(
    extra_params: Dict[str, Any], extra_opt: Any, device="cuda",
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Optional[AdamState]]:
    """A host-side JAX ``extra_params`` tree ({group: {name: array}}) and
    its ``extra_opt`` (an Adam state of the same tree) -> the port's
    ``SystemState.extra_params`` and ``extra_opt`` (keys "group/name");
    (``{}``, None) for an empty tree."""
    if not extra_params:
        return {}, None

    def dev(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=device)

    params = {group: {k: dev(v) for k, v in _flat(leaves).items()}
              for group, leaves in extra_params.items()}
    adam = AdamState(mu={k: dev(v) for k, v in _flat(extra_opt.mu).items()},
                     nu={k: dev(v) for k, v in _flat(extra_opt.nu).items()},
                     count=int(np.asarray(extra_opt.count)))
    return params, adam


def _fields(tree: Any) -> Dict[str, np.ndarray]:
    return {k: getattr(tree, k) for k in SpacetimeParams.FIELDS
            if getattr(tree, k, None) is not None}


def gaussian_state_from_numpy(tree: Any, device="cuda") -> GaussianState:
    """Params, Adam moments and count, ``alive`` and the three statistics
    buffers of a host-side JAX ``GaussianState`` -> the port's state."""

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    params = {k: dev(v) for k, v in _fields(tree.params).items()}
    adam = AdamState(
        mu={k: dev(v) for k, v in _fields(tree.adam.mu).items()},
        nu={k: dev(v) for k, v in _fields(tree.adam.nu).items()},
        count=int(np.asarray(tree.adam.count)),
    )
    stats = {k: dev(getattr(tree, k)) for k in STAT_FIELDS}
    params_cls = SpacetimeParams if any(k in params for k in TEMPORAL_FIELDS) else GaussianParams
    return GaussianState(
        params=params_cls(**params), adam=adam,
        alive=dev(tree.alive, torch.bool), **stats,
    )


def sugar_state_from_numpy(tree: Any, device="cuda") -> SuGaRState:
    """A host-side JAX ``SuGaRState`` -> the port's."""

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def fields(t):
        return {k: dev(getattr(t, k)) for k in SuGaRParams.FIELDS}

    return SuGaRState(
        params=SuGaRParams(**fields(tree.params)),
        adam=AdamState(mu=fields(tree.adam.mu), nu=fields(tree.adam.nu),
                       count=int(np.asarray(tree.adam.count))),
        faces=dev(tree.faces, torch.int64), bary=dev(tree.bary), thickness=dev(tree.thickness),
    )


def dynamic_sugar_state_from_numpy(tree: Any, device="cuda") -> DynamicSuGaRState:
    """A host-side JAX ``DynamicSuGaRState`` -> the port's (the optional
    node tracks where the JAX state has them)."""

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def fields(t):
        return {k: dev(getattr(t, k)) for k in DynamicSuGaRParams.FIELDS
                if getattr(t, k, None) is not None}

    return DynamicSuGaRState(
        params=DynamicSuGaRParams(**fields(tree.params)),
        adam=AdamState(mu=fields(tree.adam.mu), nu=fields(tree.adam.nu),
                       count=int(np.asarray(tree.adam.count))),
        faces=dev(tree.faces, torch.int64), bary=dev(tree.bary), thickness=dev(tree.thickness),
        nodes_xyz=dev(tree.nodes_xyz), skin_idx=dev(tree.skin_idx, torch.int64),
        skin_w=dev(tree.skin_w),
    )


def to_numpy(state: Any) -> Dict[str, Any]:
    """Nested dict of numpy arrays with the JAX state's field names (a
    Gaussian field's, a ``SuGaRState``'s or a ``DynamicSuGaRState``'s)."""

    def host(t):
        return t.detach().cpu().numpy()

    if isinstance(state, SuGaRState):
        buffers = ("faces", "bary", "thickness") + (
            GRAPH_FIELDS if isinstance(state, DynamicSuGaRState) else ())
        return {
            "params": {k: host(v) for k, v in state.params.as_dict().items()},
            "adam": {"mu": {k: host(v) for k, v in state.adam.mu.items()},
                     "nu": {k: host(v) for k, v in state.adam.nu.items()},
                     "count": state.adam.count},
            **{k: host(getattr(state, k)) for k in buffers},
        }
    return {
        "params": {k: host(v) for k, v in state.params.as_dict().items()},
        "adam": {
            "mu": {k: host(v) for k, v in state.adam.mu.items()},
            "nu": {k: host(v) for k, v in state.adam.nu.items()},
            "count": state.adam.count,
        },
        "alive": host(state.alive),
        **{k: host(getattr(state, k)) for k in STAT_FIELDS},
    }
