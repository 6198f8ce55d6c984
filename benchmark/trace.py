"""Reduction of a ``torch.profiler`` chrome trace of the recorded training
steps to what the per-layer readers and the result's breakdown take:
device time by kernel name and by family, the recorded steps' wall time,
the time some device operation ran (the union of kernel, copy and set
intervals), and the idle gaps, each put down to the harness's host span
(data batch, train step, logged reads) and the innermost CPU operation
the host was in at the gap's middle.

The families copy the program's ``utils/profiling.py`` ``FAMILIES``
(first match wins), with the device-to-host copies of the logged values
apart from the other copies."""

from __future__ import annotations

import bisect
import json
import re
from typing import Any, Dict, List

FAMILIES = [
    ("K1 blend forward", r"blend_fwd_kernel"),
    ("K2 blend backward", r"blend_bwd_kernel"),
    ("K3 segmented sum", r"segsum_kernel"),
    ("K4 expand", r"expand_kernel"),
    ("K5 flash attention", r"flash_fwd_(wgmma|split)|split_planes"),
    ("copy DtoH", r"Memcpy DtoH"),
    ("layout transpose (library)", r"nchwToNhwc|nhwcToNchw"),
    ("conv / matmul (library)", r"xmma|cudnn|[Cc]onv|gemm|cutlass|sm90_|wgrad|dgrad|fprop|nvjet"),
    ("norm (library)", r"group_norm|layer_norm|GroupNorm|LayerNorm|[Mm]oments"
                       r"|ComputeInternalGradients|GammaBeta"),
    ("softmax (library)", r"[Ss]oftmax"),
    ("sort (library)", r"[Rr]adix|[Ss]ort|[Mm]erge"),
    ("scan / search (library)", r"[Ss]can|[Ss]earch|cumsum"),
    ("gather / scatter / index", r"[Ii]ndex|[Gg]ather|[Ss]catter"),
    ("reduction", r"[Rr]educe"),
    ("copy / fill", r"[Mm]emcpy|[Mm]emset|copy|fill|Fill"),
    ("elementwise", r"[Ee]lementwise|vectorized|unrolled"),
]
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("bench.data_batch", "bench.train_step", "bench.logged_reads")


def family(name: str) -> str:
    return next((f for f, pat in FAMILIES if re.search(pat, name)), "other")


def _union(intervals: List[List[float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The summary of one recorded window (times in seconds)."""
    steps = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")
             and e.get("ph") == "X"]
    if not steps:
        raise ValueError("the trace holds no recorded profiler step")
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    kernels: Dict[str, float] = {}
    intervals = []
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and e.get("ph") == "X":
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts + dur < w0 or ts > w1:
                continue
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + dur / 1e6
            intervals.append([max(ts, w0), min(ts + dur, w1)])
    busy = _union(intervals)
    families: Dict[str, float] = {}
    for name, s in kernels.items():
        families[family(name)] = families.get(family(name), 0.0) + s

    # host spans and CPU operations, for the gaps
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("name") in HOST_SPANS)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                                             "python_function")
                 and not str(e.get("name", "")).startswith("ProfilerStep#"))
    op_starts = [o[0] for o in ops]
    gaps: Dict[str, float] = {}
    cuts = sorted({x for s, e, _ in spans for x in (s, e)})
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        # a gap is cut where a host span starts or ends, each piece put down
        # to the span at its middle and the innermost operation open there
        # (of those that contain it, the one that started last)
        points = [g0] + [c for c in cuts if g0 < c < g1] + [g1]
        for start, end in zip(points[:-1], points[1:]):
            if end <= start:
                continue
            mid = 0.5 * (start + end)
            span = next((n for s, e, n in spans if s <= mid <= e), "outside")
            inner = None
            k = bisect.bisect_right(op_starts, mid)
            for i in range(k - 1, max(k - 4000, 0) - 1, -1):
                if ops[i][1] >= mid:
                    inner = ops[i]
                    break
            key = span.replace("bench.", "") + (":" + inner[2] if inner else "")
            gaps[key] = gaps.get(key, 0.0) + (end - start) / 1e6
    return {
        "steps": len(steps),
        "wall_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernels": kernels,
        "families": families,
        "gaps": gaps,
    }


def read(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return summarize(json.load(fh)["traceEvents"])


def breakdown(summary: Dict[str, Any]) -> Dict[str, list]:
    """The result line's ``breakdown``: the ten device families and the ten
    idle-gap causes that took most seconds in the recorded steps."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["families"]), "idle_gaps": top(summary["gaps"])}
