"""Per-layer metric readers, one file each: ``metrics/<name>.py`` defines
``read(ctx)``, which returns the metric's value from the run's context, or
None where it finds nothing to read (the metric is then left out of the
line).  The run reports each per-layer metric of ``BENCHMARK.json`` that
lists the cell under ``workloads`` (or lists no cells).

The context (``harness.py``): ``cell`` (the cell's, configuration's and
traffic's files), ``data_ms`` (host ms of each window step's camera
batch), ``flags`` (TF32 switches), ``batch_shape`` (the first camera
batch's views, height and width), ``batch`` (the first camera batch, as
recorded for the reference), ``card`` (name, highest SM clock, power
limit), ``trace`` (``trace.summarize`` of the recorded steps), ``spans``
(``spans.from_profiler`` of them, or None), ``k5_launches`` (K5 launches
by shape tag in the recorded steps) and ``step_s_untraced`` (the traced
run's step time after the recorded steps)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                  os.path.join(HERE, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(cell_name: str, root: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    return [m for m in spec["per_layer"] if cell_name in m.get("workloads", [cell_name])]


def read_all(cell_name: str, ctx: Dict[str, Any], root: str) -> Dict[str, Dict[str, Any]]:
    out = {}
    for metric in per_layer(cell_name, root):
        value = reader(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out
