"""Kind modules, one file each: a configuration's ``kind`` names
``kinds/<kind>.py`` under the benchmark directory its cell was loaded
from, found by path as ``metrics/<name>.py`` is, so a configuration of a
new kind joins as files alone.  A kind module defines:

  * ``weight_files(config)``: the sub-model directories of the weight set,
    in the order they are drawn, each a dict with ``name`` (the directory),
    ``config`` (its ``config.json`` body), ``shapes`` (tensor name ->
    shape, in draw order) and optionally ``file`` (the weights' file name,
    ``weights.FILE`` by default);
  * ``Reference(yaml_cfg, config, weights, device, precision)``: the plain
    reference step, with ``weights`` each sub-model's state dict by name;
    ``init_state(seed)``; ``step(state, batch, step, draws) -> (loss,
    grads)`` with ``draws`` a ``reference.train.Draws``; ``flat(state)``,
    the trained leaves by name;
  * ``inputs(cell, seed, run_dir)`` (optional): writes the run's seeded
    input files into ``run_dir`` and returns the YAML overrides that point
    at them;
  * ``model_seconds(config, ctx, flags)``: the least time the card's peaks
    allow for the step's model FLOPs (``mfu``'s numerator), from the
    readers' context (``metrics/__init__.py``)."""

from __future__ import annotations

import importlib.util
import os
import re
from typing import Any, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIND = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]*$")


def load(cell: Dict[str, Any]):
    """The kind module of the cell's configuration; raises
    ``FileNotFoundError`` naming ``kinds/<kind>.py`` where there is none."""
    config = cell["config"]
    kind = str(config.get("kind"))
    path = os.path.join(cell.get("dir", BENCH_DIR), "kinds", kind + ".py")
    if not KIND.match(kind) or not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {config.get('name')!r} has kind {kind!r}, "
                                f"but there is no kind module kinds/{kind}.py ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark.kinds.{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
