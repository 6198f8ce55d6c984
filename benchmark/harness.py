"""One benchmark run of a cell: the program's ``Trainer.fit`` built the way
the launcher builds it, its first steps checked against the plain
reference, a window of steps timed on the host clock and, with tracing,
a few of them recorded by ``torch.profiler``.

A run, in order:

 1. the cell's files (``workloads/<cell>.json`` names ``configs/<config>``
    and ``traffic/<traffic>``) and the configuration's kind module
    (``kinds/<kind>.py``); a card, or it stops before any result;
 2. the weights of the (configuration, seed) pair, the sub-models the
    kind names (``weights.py``; the seconds spent writing them are not
    set-up);
 3. the kind's seeded input files, where it has any, in a run directory
    inside the checkout; the trainer from the traffic's YAML with its
    overrides, the seed, the weights, the run directory and the inputs'
    overrides; the initial state;
 4. ``fit`` with an ``on_step`` hook.  The first ``warmup_steps`` steps
    warm every shape up and are the steps the reference follows: the
    random draws they take from the step generator are recorded (a
    ``TorchFunctionMode`` over the calls given a ``generator``), and so are
    their camera batches, the Adam moments after the first step and the
    parameters after the last; then the window: every step's end on the
    host clock until ``seconds`` have passed, when the hook ends ``fit``;
    with tracing, the first steps of the window under the profiler
    (skip 1, warm up 1, record ``trace_steps``);
 5. the peak device memory, then the program's state is freed;
 6. the reference follows the warm-up steps (``compare.py``) and decides
    ``correct``."""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import kinds

FORBIDDEN = ("jax", "jaxlib", "flax", "threestudio_3dgs_tpu")
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
UNTRACED_STEPS = 5  # steps a traced run times after its recorded ones, at least


class WindowEnd(Exception):
    """Raised by the hook to end ``fit`` once the window's time is up."""


class CardMissing(RuntimeError):
    pass


def load_cell(name: str, bench_dir: str = BENCH_DIR) -> Dict[str, Any]:
    def read(*parts):
        with open(os.path.join(bench_dir, *parts)) as f:
            return json.load(f)

    cell = read("workloads", name + ".json")
    return {"name": name, "cell": cell, "config": read("configs", cell["config"] + ".json"),
            "traffic": read("traffic", cell["traffic"] + ".json"), "dir": bench_dir}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info(torch) -> Dict[str, Any]:
    info = {"name": torch.cuda.get_device_name(0), "sm_hz": None, "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20).stdout.splitlines()[0].split(",")
        info["sm_hz"] = float(out[0]) * 1e6
        info["power_limit"] = out[1].strip() + " W"
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        pass
    return info


class DrawRecorder:
    """Records, in order, the values of every torch call given a
    ``generator`` (the step's draws) while it is entered."""

    def __init__(self):
        import torch
        from torch.overrides import TorchFunctionMode

        recorder = self

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if kwargs.get("generator") is not None and isinstance(out, torch.Tensor):
                    recorder.draws.append((getattr(func, "__name__", str(func)),
                                           out.detach().clone()))
                return out

        self.draws: List[tuple] = []
        self.mode = _Mode()
        self.active = False

    def start(self):
        self.mode.__enter__()
        self.active = True

    def stop(self):
        if self.active:
            self.mode.__exit__(None, None, None)
            self.active = False


def _host_copy(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (np.array(v) if isinstance(v, np.ndarray) else copy.deepcopy(v))
            for k, v in batch.items()}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root: str = ".", device: str = "cuda", require_card: bool = True,
        control: bool = False, fault: Optional[Callable] = None,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
        cell: Optional[Dict[str, Any]] = None,
        t_process: Optional[float] = None,
        work_dir: Optional[str] = None) -> Dict[str, Any]:
    """One run; returns the result object (``correct`` ... ``device``) and,
    under the key ``compared``, the numbers compared with their limits.
    ``control`` puts the reference, one precision down, in the program's
    place; ``fault`` (tests) is called with the trainer before ``fit``.
    ``work_dir`` (tests) holds the weights and the run directory instead of
    ``benchmark/.cache`` and ``benchmark/.runs``."""
    t_start = time.perf_counter() if t_process is None else t_process
    root = os.path.abspath(root)
    cell = cell or load_cell(cell_name)
    config, traffic = cell["config"], cell["traffic"]
    kind = kinds.load(cell)
    cache = os.path.join(work_dir or os.path.join(root, "benchmark"), ".cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    chips = int(cell["cell"].get("chips", 1))
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise CardMissing(f"the cell needs {chips} CUDA device(s); "
                              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if not os.path.isdir(os.path.join(root, "threestudio_3dgs_tpu_torch")):
        raise FileNotFoundError(f"no threestudio_3dgs_tpu_torch under {root}: the program is "
                                "not in this checkout")
    if root not in sys.path:
        sys.path.insert(0, root)

    from . import compare, spans, weights
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.ops import native
    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    dev = launch.resolve_device(device)
    wdir, write_s = weights.ensure(cache, config, seed, dev, kind.weight_files(config))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"[bench] weights {os.path.relpath(wdir, root)} ({'written in %.1f s' % write_s if write_s else 'cached'})")

    run_dir = os.path.join(work_dir or os.path.join(root, "benchmark"), ".runs", cell_name)
    shutil.rmtree(run_dir, ignore_errors=True)
    overrides = list(traffic.get("overrides", [])) + [
        f"seed={seed}", f"exp_root_dir={run_dir}",
        f"system.guidance.pretrained_model_name_or_path={wdir}",
    ]
    if hasattr(kind, "inputs"):
        os.makedirs(run_dir)
        overrides += list(kind.inputs(cell, seed, run_dir))
    cfg = load_config(os.path.join(root, traffic["yaml"]), overrides)
    trainer = Trainer(cfg, device=dev)
    trainer.state = trainer.system.init_state(cfg.seed)
    p0 = {k: v.detach().clone() for k, v in _leaves(trainer.state).items()}
    if fault is not None:
        fault(trainer)

    warm = int(traffic.get("warmup_steps", 3))
    wait, warmup_t, active = 1, 1, int(traffic.get("trace_steps", 3))
    rec = DrawRecorder()
    batches: List[Dict[str, Any]] = []
    step_draws: List[List[tuple]] = []
    host: Dict[str, Any] = {"data_s": [], "t_hooks": [], "t0": None, "g1": None, "p3": None,
                            "reads_span": None, "prof": None}

    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = profile(activities=activities,
                           schedule=schedule(wait=wait, warmup=warmup_t, active=active, repeat=1))
    else:
        record_function = None

    def span(name):
        return record_function(name) if record_function else contextlib.nullcontext()

    data_fn, step_fn = trainer.data.train_batch, trainer.system.train_step

    def timed_batch(step):
        t = time.perf_counter()
        with span("bench.data_batch"):
            batch = data_fn(step)
        host["data_s"].append((step, time.perf_counter() - t))
        if len(batches) < warm:
            batches.append(_host_copy(batch))
        return batch

    def timed_step(*args, **kwargs):
        with span("bench.train_step"):
            out = step_fn(*args, **kwargs)
        if record_function is not None:
            host["reads_span"] = record_function("bench.logged_reads")
            host["reads_span"].__enter__()
        return out

    trainer.data.train_batch = timed_batch
    trainer.system.train_step = timed_step

    def on_step():
        now = time.perf_counter()
        if host["reads_span"] is not None:
            host["reads_span"].__exit__(None, None, None)
            host["reads_span"] = None
        n = trainer.step
        if n <= warm:
            step_draws.append(list(rec.draws))
            rec.draws.clear()
            if n == 1:
                host["g1"] = _adam_grads(trainer.state, torch)
            if n == warm:
                rec.stop()
                host["p3"] = {k: v.detach().clone() for k, v in _leaves(trainer.state).items()}
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                host["t0"] = time.perf_counter()
                if profiler is not None:
                    profiler.start()
            return
        host["t_hooks"].append(now)
        k = len(host["t_hooks"])
        if profiler is not None and host["prof"] is None:
            if k == wait + warmup_t:
                host["k5_start"] = dict(native.SHAPE_LAUNCHES)
            profiler.step()
            if k == wait + warmup_t + active:
                host["k5_end"] = dict(native.SHAPE_LAUNCHES)
                profiler.stop()
                host["prof"] = profiler
                host["t_after_trace"] = time.perf_counter()
                host["trace_end_hook"] = k
        # a traced run also times UNTRACED_STEPS steps after its recorded ones
        traced = profiler is None or (host["prof"] is not None
                                      and k - host["trace_end_hook"] >= UNTRACED_STEPS)
        if traced and now - host["t0"] >= seconds:
            raise WindowEnd()

    rec.start()
    try:
        trainer.fit(on_step=on_step)
    except WindowEnd:
        pass
    finally:
        rec.stop()
        if profiler is not None and host["prof"] is None:
            profiler.stop()
    hooks = host["t_hooks"]
    if not hooks:
        raise RuntimeError("the window completed no step")
    window_s = hooks[-1] - host["t0"]
    n_window = len(hooks)
    setup_s = host["t0"] - t_start - write_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    losses = [row.get("train/loss_total") for row in trainer.metrics_log]
    failed = sum(1 for v in losses[warm:] if v is None or not np.isfinite(v))
    prog = {"loss": [float(v) for v in losses[:warm]], "p0": p0, "p3": host["p3"],
            "g1": host["g1"], "batches": batches, "draws": step_draws, "seed": seed,
            "root": root, "overrides": overrides}
    data_ms = [s * 1e3 for step, s in host["data_s"] if step >= warm]

    first = batches[0]
    ctx: Dict[str, Any] = {"cell": cell, "data_ms": data_ms, "flags": _flags(torch),
                           "batch_shape": (int(first["c2w"].shape[0]), int(first["height"]),
                                           int(first["width"])), "batch": first}
    if trace and host["prof"] is not None:
        from . import trace as trace_mod

        path = os.path.join(run_dir, "trace.json")
        host["prof"].export_chrome_trace(path)
        ctx["trace"] = trace_mod.read(path)
        os.remove(path)
        ctx["spans"] = spans.from_profiler(host["prof"])
        ctx["k5_launches"] = {tag: host["k5_end"].get((fn, tag), 0) - host["k5_start"].get((fn, tag), 0)
                              for (fn, tag) in host["k5_end"] if fn == "flash_attention_forward"}
        # the steps after the recorded ones, timed from the profiler's stop
        n_after = len(hooks) - host["trace_end_hook"]
        if n_after > 0:
            ctx["step_s_untraced"] = (hooks[-1] - host["t_after_trace"]) / n_after
        ctx["card"] = card_info(torch) if dev.type == "cuda" else {}
    del trainer, data_fn, step_fn, timed_batch, timed_step, on_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared = compare.judge(cell, wdir, prog, dev, control=control, log=log)
    shutil.rmtree(run_dir, ignore_errors=True)
    result: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": n_window,
        "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)},
    }
    if not trace:
        result["metrics"] = {
            "step_ms": {"value": window_s / n_window * 1e3, "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    elif "trace" in ctx:
        from . import metrics as readers, trace as trace_mod

        result["metrics"] = readers.read_all(cell_name, ctx, root)
        result["device"]["busy_s"] = ctx["trace"]["busy_s"]
        result["device"]["window_s"] = ctx["trace"]["wall_s"]
        result["breakdown"] = trace_mod.breakdown(ctx["trace"])
    result["compared"] = compared
    log(f"[bench] {cell_name} seed {seed}: {n_window} steps in {window_s:.3f} s, set-up "
        f"{setup_s:.2f} s, peak {peak / 2**30:.3f} GiB")
    return result


def _leaves(state) -> Dict[str, Any]:
    """The trained leaves of a system state by name: the field's and the
    background's (``background/<name>``)."""
    leaves = {k: v for k, v in state.gauss.params.as_dict().items() if v.numel()}
    for group, params in (state.extra_params or {}).items():
        leaves.update({f"{group}/{k}": v for k, v in params.items()})
    return leaves


def _adam_grads(state, torch) -> Dict[str, Any]:
    """The first step's gradient of every leaf as Adam took it: its first
    moment after one step over (1 - beta1)."""
    grads = {k: v / 0.1 for k, v in state.gauss.adam.mu.items() if v.numel()}
    if state.extra_opt is not None:
        grads.update({k: v / 0.1 for k, v in state.extra_opt.mu.items()})
    return {k: v.detach().clone() for k, v in grads.items()}


def _flags(torch) -> Dict[str, bool]:
    return {"cudnn_tf32": bool(torch.backends.cudnn.allow_tf32),
            "matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
