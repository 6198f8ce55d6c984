"""The check that decides ``correct``: the plain reference of the
configuration's kind (``kinds/<kind>.py``'s ``Reference``) follows the
warm-up steps the program took inside ``fit`` (same seed, camera batches,
draws and input files; its own initial field, background MLP and weights
read from the same files) and the numbers the cell names are held to its
limits:

  * ``loss``: the worst step's |program - reference| / |reference| of the
    total loss;
  * ``grad``: the worst leaf's gap between the norms of the first step's
    gradient (the program's worked out from its Adam state after one
    step), over the larger of the reference's norm of that leaf and of the
    median leaf;
  * ``change``: the same of the parameters' change over the warm-up steps;
  * ``change_median``: the median leaf's instead of the worst leaf's.

A cell holds the numbers its ``limits`` name (the others are logged):
where the program's worst leaf is one small leaf's noise, as the
opacities' under the bf16 guidance, the median leaf's change is the
steady number.

The initial parameters' worst-leaf |program - reference| / |reference| is
logged beside them: the reference draws its own start from the seed.

``grad`` and ``change`` leave out the leaves whose reference gradient is
zero or under a thousandth of the median nonzero leaf's: their Adam steps
are round-off (the isotropic field's rotations) or nothing (the
background when every view's background is augmented).

With ``control`` the reference one precision below the configuration's
(``config["control"]``) stands in the program's place."""

from __future__ import annotations

import os
import statistics
import time
from typing import Any, Callable, Dict, List

import torch
import yaml

from . import kinds, weights
from .reference import diffusion, train

FLOOR = 1e-3  # a leaf counts when its reference gradient is at least this x the median's


def _median(norms) -> float:
    """The median leaf's norm, of the leaves whose norm is not zero (an
    augmented view leaves the background's gradient exactly zero)."""
    nonzero = [v for v in norms if v > 0]
    return statistics.median(nonzero) if nonzero else 0.0


def _norm(t) -> float:
    return float(t.double().norm())


def _gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> Dict[str, float]:
    """Each kept leaf's |norm(program) - norm(reference)| over the larger of
    its reference norm and the median leaf's."""
    norms = {k: _norm(ref[k]) for k in keep}
    median = _median(norms.values())
    return {k: abs(_norm(prog[k]) - norms[k]) / max(norms[k], median, 1e-30) for k in keep}


def apply_overrides(cfg: dict, overrides: List[str]) -> dict:
    """The YAML with ``key.path=value`` overrides (values read as YAML)."""
    for item in overrides:
        path, _, value = item.partition("=")
        node = cfg
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = yaml.safe_load(value)
    return cfg


def follow(cell: Dict[str, Any], wdir: str, prog: Dict[str, Any], device,
           precision: diffusion.Precision) -> Dict[str, Any]:
    """The reference's initial leaves, losses, first gradients and leaves
    after the warm-up steps, in ``precision``."""
    with open(os.path.join(prog["root"], cell["traffic"]["yaml"])) as f:
        yaml_cfg = apply_overrides(yaml.safe_load(f), prog["overrides"])
    config = cell["config"]
    kind = kinds.load(cell)
    model_w = {sub["name"]: diffusion.load_weights(
        os.path.join(wdir, sub["name"], sub.get("file", weights.FILE)), device)
        for sub in kind.weight_files(config)}
    ref = kind.Reference(yaml_cfg, config, model_w, device, precision)
    state = ref.init_state(prog["seed"])
    p0 = {k: v.clone() for k, v in ref.flat(state).items()}
    losses, g1 = [], None
    for step, (batch, draws) in enumerate(zip(prog["batches"], prog["draws"])):
        loss, grads = ref.step(state, batch, step, train.Draws(list(draws)))
        losses.append(loss)
        if step == 0:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
    p3 = {k: v.clone() for k, v in ref.flat(state).items()}
    del model_w, ref, state
    return {"loss": losses, "p0": p0, "g1": g1, "p3": p3}


def numbers(prog: Dict[str, Any], ref: Dict[str, Any], log: Callable[[str], None] = print
            ) -> Dict[str, float]:
    """The compared numbers of a program run against the reference
    (each leaf's gaps logged)."""
    out: Dict[str, float] = {}
    init = []
    for k, r in ref["p0"].items():
        p = prog["p0"][k].to(r.device).float()
        n = r.shape[0]
        diff = (p[:n] - r).double().norm() ** 2 + p[n:].double().norm() ** 2
        init.append(float(diff.sqrt()) / max(_norm(r), 1e-30))
    log(f"[bench] init: worst leaf |program - reference| / |reference| {max(init):.3g} "
        "(logged, not compared: no control or fault moves it)")
    out["loss"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    gnorms = {k: _norm(g) for k, g in ref["g1"].items()}
    keep = [k for k, v in gnorms.items() if v > 0 and v >= FLOOR * _median(gnorms.values())]
    dev = next(iter(ref["g1"].values())).device
    grad = _gaps({k: prog["g1"][k].to(dev) for k in keep}, ref["g1"], keep)
    d_prog = {k: (prog["p3"][k] - prog["p0"][k]).to(dev) for k in keep}
    d_ref = {k: ref["p3"][k] - ref["p0"][k] for k in keep}
    change = _gaps(d_prog, d_ref, keep)
    log("[bench] leaves (reference grad norm; grad gap; change gap): " + ", ".join(
        f"{k} {gnorms[k]:.4g}; {grad[k]:.3g}; {change[k]:.3g}" for k in keep)
        + "; left out: " + (", ".join(f"{k} {v:.3g}" for k, v in gnorms.items() if k not in keep)
                            or "none"))
    out["grad"], out["change"] = max(grad.values()), max(change.values())
    out["change_median"] = statistics.median(change.values())
    return out


def judge(cell: Dict[str, Any], wdir: str, prog: Dict[str, Any], device, *,
          control: bool = False, log: Callable[[str], None] = print) -> Dict[str, Dict[str, float]]:
    """The compared numbers with their limits; each is logged beside its
    limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = cell["cell"]["limits"]
    t0 = time.perf_counter()
    try:
        ref = follow(cell, wdir, prog, device, diffusion.F32)
    except (ValueError, RuntimeError) as e:
        # the program's draws or shapes are not the step's: not correct
        log(f"[bench] the reference could not follow the program's steps: {e!r}")
        return {k: {"value": 1e300, "limit": float(v)} for k, v in limits.items()}
    log(f"[bench] reference: {len(ref['loss'])} steps in {time.perf_counter() - t0:.2f} s")
    if control:
        ctl = follow(cell, wdir, prog, device, diffusion.Precision(cell["config"]["control"]))
        prog = dict(prog, loss=ctl["loss"], g1=ctl["g1"], p3=ctl["p3"],
                    p0={k: v for k, v in ctl["p0"].items()})
    values = numbers(prog, ref, log)
    log("[bench] numbers " + ", ".join(f"{k} {v:.4g}" for k, v in values.items()))
    compared = {k: {"value": values[k], "limit": float(limit)} for k, limit in limits.items()}
    log("[bench] losses program " + " ".join(f"{v:.6g}" for v in prog["loss"])
        + " reference " + " ".join(f"{v:.6g}" for v in ref["loss"]))
    return compared
