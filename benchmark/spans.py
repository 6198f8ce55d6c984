"""Reduction of a ``torch.profiler`` chrome trace of the recorded training
steps by the program's own spans (``threestudio_3dgs_tpu_torch/utils/
tracing.py``): device time, host self time, device-idle time and span
counts, each keyed by the span's path (its names from the outermost
program span down, joined by " > ").

Program spans are the ``user_annotation`` events named in the program's
``SPANS``.  Each device event (kernel, copy, set) in the recorded window
is put down to one span, by these rules in order:

  1. the innermost program span open on the thread of its runtime launch
     (the ``cuda_runtime`` / ``cuda_driver`` event of the same
     ``correlation``), at the launch;
  2. else, where the launch lies inside a backward op (an op with a
     ``Sequence number`` and a nonzero ``Fwd thread id``), the forward op
     the profiler links it to (its ``fwdbwd`` flow, else the latest
     forward op before it with the same sequence number): the innermost
     program span open on the forward op's thread at its start;
  3. else the innermost program span open on any thread at the launch;
  4. else ``outside``.

A span's host self time is its length less its child program spans'.  The
device-idle time (the recorded window less the union of device events) is
cut at the edges of the program spans on the main thread (the one that
records the profiler steps), and each piece put down to the innermost of
them open at its middle, or ``outside``.  A program without spans (an
older checkout) gives None.

The harness of this directory removes its exported trace before the
readers run, and a profiler exports once; it reduces the same events,
which the finished profiler's ``events()`` keep after the export, with
``from_profiler`` and hands the reduction to the readers as
``ctx["spans"]``."""

from __future__ import annotations

import bisect
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from benchmark.trace import DEVICE_CATEGORIES, _union

SEP = " > "
OUTSIDE = "outside"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
FLOW_FWD_BWD = 1  # a profiler event's flow_type for the forward-backward link


def program_spans() -> Tuple[str, ...]:
    """The program's span names, or none where it has no tracing module."""
    try:
        from threestudio_3dgs_tpu_torch.utils.tracing import SPANS
    except ImportError:
        return ()
    return tuple(SPANS)


class Nest:
    """Properly nested half-open intervals of one thread, for the innermost
    one open at a time."""

    def __init__(self, items: List[Tuple[float, float, Any]]):
        self.items = sorted(items, key=lambda it: (it[0], -it[1]))
        self.starts = [it[0] for it in self.items]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (start, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def find(self, t: float) -> int:
        """The index of the innermost interval that holds ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] <= t:
            i = self.parent[i]
        return i

    def path(self, i: int) -> List[int]:
        out = []
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out[::-1]


def _is_backward(e: Dict[str, Any]) -> bool:
    args = e.get("args", {})
    return "Sequence number" in args and args.get("Fwd thread id", 0) != 0


def reduce(events: List[Dict[str, Any]], names: Sequence[str]) -> Optional[Dict[str, Any]]:
    """The reduction of one recorded window by the spans ``names`` (times in
    seconds), or None when the window holds none of them."""
    names = set(names)
    steps = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")
             and e.get("ph") == "X"]
    if not steps or not names:
        return None
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    main_tid = steps[0].get("tid")

    by_tid: Dict[Any, List[Tuple[float, float, str]]] = {}
    bwd_by_tid: Dict[Any, List[Tuple[float, float, Dict]]] = {}
    fwd_by_seq: Dict[int, List[Tuple[float, Any]]] = {}
    launches: Dict[Any, Tuple[Any, float]] = {}
    flow_s: Dict[Any, Tuple[Any, float]] = {}
    flow_f: Dict[Tuple[Any, float], Any] = {}
    device = []
    for e in events:
        ph, cat = e.get("ph"), e.get("cat")
        if ph == "X" and cat == "user_annotation" and e.get("name") in names:
            ts = float(e["ts"])
            by_tid.setdefault(e.get("tid"), []).append((ts, ts + float(e["dur"]), e["name"]))
        elif ph == "X" and cat == "cpu_op" and "Sequence number" in e.get("args", {}):
            ts = float(e["ts"])
            if _is_backward(e):
                bwd_by_tid.setdefault(e.get("tid"), []).append(
                    (ts, ts + float(e["dur"]), e))
            else:
                fwd_by_seq.setdefault(e["args"]["Sequence number"], []).append(
                    (ts, e.get("tid")))
        elif ph == "X" and cat in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif ph == "X" and cat in DEVICE_CATEGORIES:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts + dur >= w0 and ts <= w1:
                device.append((max(ts, w0), min(ts + dur, w1), e.get("args", {})))
        elif cat == "fwdbwd" and ph == "s":
            flow_s[e.get("id")] = (e.get("tid"), float(e["ts"]))
        elif cat == "fwdbwd" and ph == "f":
            flow_f[(e.get("tid"), float(e["ts"]))] = e.get("id")
    if not any(w0 <= s < w1 for spans in by_tid.values() for s, _, _ in spans):
        return None
    nests = {tid: Nest(spans) for tid, spans in by_tid.items()}
    bwd_nests = {tid: Nest(ops) for tid, ops in bwd_by_tid.items()}
    for ops in fwd_by_seq.values():
        ops.sort()

    def span_at(tid, t) -> Optional[Tuple[Any, int]]:
        nest = nests.get(tid)
        i = nest.find(t) if nest else -1
        return (tid, i) if i >= 0 else None

    def linked_forward(tid, t) -> Optional[Tuple[Any, float]]:
        nest = bwd_nests.get(tid)
        if not nest:
            return None
        chain = nest.path(nest.find(t))
        for i in reversed(chain):  # the innermost backward op first
            start, _, op = nest.items[i]
            flow = flow_f.get((tid, start))
            if flow in flow_s:
                return flow_s[flow]
        for i in reversed(chain):
            start, _, op = nest.items[i]
            fwd = fwd_by_seq.get(op["args"]["Sequence number"], [])
            k = bisect.bisect_left(fwd, (start,)) - 1
            if k >= 0:
                return fwd[k][1], fwd[k][0]
        return None

    def innermost_anywhere(t) -> Optional[Tuple[Any, int]]:
        best = None
        for tid, nest in nests.items():
            i = nest.find(t)
            if i >= 0 and (best is None or nest.items[i][0] > nests[best[0]].items[best[1]][0]):
                best = (tid, i)
        return best

    def key(found: Optional[Tuple[Any, int]]) -> str:
        if found is None:
            return OUTSIDE
        tid, i = found
        nest = nests[tid]
        return SEP.join(nest.items[j][2] for j in nest.path(i))

    device_s: Dict[str, float] = {}
    for start, end, args in device:
        found = None
        launch = launches.get(args.get("correlation"))
        if launch is not None:
            found = span_at(*launch)
            if found is None:
                fwd = linked_forward(*launch)
                if fwd is not None:
                    found = span_at(*fwd)
            if found is None:
                found = innermost_anywhere(launch[1])
        k = key(found)
        device_s[k] = device_s.get(k, 0.0) + (end - start) / 1e6

    host_self_s: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for tid, nest in nests.items():
        child_us = [0.0] * len(nest.items)
        for i, p in enumerate(nest.parent):
            if p >= 0:
                child_us[p] += nest.items[i][1] - nest.items[i][0]
        for i, (start, end, _) in enumerate(nest.items):
            if w0 <= start < w1:
                k = key((tid, i))
                host_self_s[k] = host_self_s.get(k, 0.0) + (end - start - child_us[i]) / 1e6
                count[k] = count.get(k, 0) + 1

    busy = _union([[s, e] for s, e, _ in device])
    main = nests.get(main_tid)
    cuts = sorted({x for s, e, _ in (main.items if main else []) for x in (s, e)})
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle_s: Dict[str, float] = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        points = [g0] + cuts[bisect.bisect_right(cuts, g0):bisect.bisect_left(cuts, g1)] + [g1]
        for a, b in zip(points[:-1], points[1:]):
            if b > a:
                k = key(span_at(main_tid, 0.5 * (a + b)))
                idle_s[k] = idle_s.get(k, 0.0) + (b - a) / 1e6
    return {"steps": len(steps), "wall_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6, "device_s": device_s,
            "host_self_s": host_self_s, "idle_s": idle_s, "count": count}


def read(path: str, names: Optional[Sequence[str]] = None) -> Optional[Dict[str, Any]]:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return reduce(events, program_spans() if names is None else names)


def under(table: Dict[str, float], names: Sequence[str]) -> float:
    """The sum of ``table`` over the paths that pass through any of
    ``names``."""
    return sum(v for path, v in table.items() if set(path.split(SEP)) & set(names))


def per_step_ms(ctx: Dict[str, Any], table: str, names: Sequence[str]) -> Optional[float]:
    """ms a recorded step of ``table`` under ``names``, or None without a
    reduction with device events."""
    s = ctx.get("spans")
    if not s or not s["device_s"]:
        return None
    return under(s[table], names) / s["steps"] * 1e3


def _name(e) -> str:
    """A profiler event's name as the chrome trace has it (``name`` puts a
    wildcard in ``ProfilerStep#N``)."""
    return getattr(e, "trace_name", None) or e.name


def _category(e, names) -> str:
    """A profiler event's chrome category: its ``activity_type`` where the
    event has one (newer torch), else from its device, annotation flag and
    name (a CPU event named ``cuda*`` / ``cu*`` is a runtime or driver call)."""
    cat = getattr(e, "activity_type", None)
    if cat:
        return cat
    name = _name(e)
    annotation = (getattr(e, "is_user_annotation", False) or name in names
                  or name.startswith("ProfilerStep#"))
    if str(e.device_type).endswith("CUDA"):
        return "gpu_user_annotation" if annotation else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def profiler_events(prof, names: Sequence[str] = ()) -> List[Dict[str, Any]]:
    """A finished profiler's events (``prof.events()``, kept after its one
    chrome export) in the chrome trace's form: each its category, name,
    thread, start and length in us, its correlation (device events and
    runtime launches), sequence number and forward thread (ops), and the
    forward-backward flows' ends where the events carry them."""
    names = set(names)
    out = []
    for e in prof.events():
        cat = _category(e, names)
        start = float(e.time_range.start)
        args: Dict[str, Any] = {}
        if cat in DEVICE_CATEGORIES or cat in LAUNCH_CATEGORIES:
            args["correlation"] = e.id
        if getattr(e, "sequence_nr", -1) >= 0:
            args["Sequence number"] = e.sequence_nr
            args["Fwd thread id"] = e.fwd_thread
        out.append({"ph": "X", "cat": cat, "name": _name(e), "tid": e.thread, "ts": start,
                    "dur": float(e.time_range.end) - start, "args": args})
        if getattr(e, "flow_type", 0) == FLOW_FWD_BWD and getattr(e, "flow_id", 0):
            out.append({"ph": "s" if e.flow_start else "f", "cat": "fwdbwd", "id": e.flow_id,
                        "tid": e.thread, "ts": start})
    return out


def from_profiler(prof) -> Optional[Dict[str, Any]]:
    """The reduction of a finished profiler's recorded window by the
    program's spans, or None."""
    names = program_spans()
    return reduce(profiler_events(prof, names), names)


def table(summary: Dict[str, Any]) -> List[List[Any]]:
    """Rows of (path, device ms, host self ms, idle ms, count) a recorded
    step, the most device time first."""
    n = summary["steps"]
    paths = set(summary["device_s"]) | set(summary["host_self_s"]) | set(summary["idle_s"])
    rows = [[p, summary["device_s"].get(p, 0.0) / n * 1e3,
             summary["host_self_s"].get(p, 0.0) / n * 1e3,
             summary["idle_s"].get(p, 0.0) / n * 1e3, summary["count"].get(p, 0) / n]
            for p in paths]
    return sorted(rows, key=lambda r: (-r[1], -r[3]))
