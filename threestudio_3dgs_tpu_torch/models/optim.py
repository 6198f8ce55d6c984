"""Per-group Adam for Gaussian fields (port of the JAX package's
``models/optim.py``).

The moments are dictionaries shaped like the parameters; the update runs in
place under ``torch.no_grad`` (the JAX package returns new arrays; updating
in place keeps one copy of each buffer on the card).  Bias correction as
torch.optim.Adam: update = lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps),
with the scalars rounded through float32 as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lrs: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> Dict[str, torch.Tensor]:
    """One Adam step.  Updates `state` in place and returns the new params
    (fresh tensors; the caller decides which rows to keep)."""
    state.count += 1
    t = np.float32(state.count)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    new = {}
    for k, p in params.items():
        g = grads[k]
        m = state.mu[k]
        v = state.nu[k]
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        lr = float(np.float32(lrs[k]))
        new[k] = p - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    return new


def row_mask(rows: torch.Tensor, cap: int) -> torch.Tensor:
    """(cap,) bool, True at each of `rows`; rows outside [0, cap) are dropped
    (the JAX package's scatters with ``mode="drop"``)."""
    hit = torch.zeros(cap + 1, dtype=torch.bool, device=rows.device)
    ok = (rows >= 0) & (rows < cap)
    hit[torch.where(ok, rows, torch.full_like(rows, cap))] = True
    return hit[:cap]


@torch.no_grad()
def zero_moments_where(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero both moments of the rows where the (cap,) mask is set, in every
    field, in place.  ``count`` is unchanged."""
    for moments in (state.mu, state.nu):
        for v in moments.values():
            v.masked_fill_(mask.reshape((-1,) + (1,) * (v.dim() - 1)), 0.0)
    return state


def zero_moments_at(state: AdamState, rows: torch.Tensor) -> AdamState:
    """Zero both moments of the given rows in every field, in place; rows out
    of range are dropped.  ``count`` is unchanged."""
    return zero_moments_where(state, row_mask(rows, next(iter(state.mu.values())).shape[0]))


@torch.no_grad()
def zero_moments_field(state: AdamState, field: str) -> AdamState:
    """Zero all moments of one named field, in place."""
    state.mu[field].zero_()
    state.nu[field].zero_()
    return state


def clone_adam(state: AdamState) -> AdamState:
    return AdamState(
        mu={k: v.clone() for k, v in state.mu.items()},
        nu={k: v.clone() for k, v in state.nu.items()},
        count=state.count,
    )
