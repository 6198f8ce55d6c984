"""The reduction by program span (``spans.py``) and its readers on a small
canned trace of two recorded steps, with the values worked out by hand.

Main thread 1, autograd's device thread 2; times in us.  Step 1 holds a
launch under a forward span (the render's kernel), a backward kernel
linked to its forward op by sequence number (the guidance's) and one by
the profiler's flow or, without it, its sequence number (the render's), a kernel under ``render/backward``,
one under no span on its thread nor linked (``system/backward`` on the
main thread), one launched nowhere (``outside``) and three reads; step 2
an idle train step with one densify kernel."""

import pytest

from benchmark import metrics, spans
from threestudio_3dgs_tpu_torch.utils.tracing import SPANS


def X(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid, "args": args}


def K(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": 7,
            "args": {"correlation": corr}}


def L(ts, corr, tid=1):
    return X("cudaLaunchKernel", ts, 2, cat="cuda_runtime", tid=tid, correlation=corr)


EVENTS = [
    X("ProfilerStep#4", 0, 1000), X("ProfilerStep#5", 1000, 1000),
    X("bench.train_step", 100, 800),  # a harness span: not the program's
    X("fit/data", 0, 100), X("data/rays", 10, 50),
    X("fit/train_step", 100, 800),
    X("system/loss", 100, 300),
    X("system/render", 110, 140), X("render/host_read", 200, 40),
    X("system/guidance", 260, 120),
    X("system/backward", 400, 300),
    X("system/update", 700, 80), X("system/densify", 780, 70),
    X("fit/host_read", 900, 50), X("fit/host_read", 950, 30),
    X("render/backward", 500, 60, tid=2),
    X("fit/data", 1000, 100), X("fit/train_step", 1100, 800), X("system/densify", 1800, 50),
    # forward ops and the backward ops of the autograd thread
    X("aten::mul", 130, 5, cat="cpu_op", **{"Sequence number": 9, "Fwd thread id": 0}),
    X("aten::convolution", 270, 20, cat="cpu_op", **{"Sequence number": 7, "Fwd thread id": 0}),
    X("ConvolutionBackward0", 600, 50, cat="cpu_op", tid=2,
      **{"Sequence number": 7, "Fwd thread id": 1}),
    X("MulBackward0", 655, 20, cat="cpu_op", tid=2, **{"Sequence number": 9, "Fwd thread id": 1}),
    {"ph": "s", "cat": "fwdbwd", "id": 1, "tid": 1, "ts": 130},
    {"ph": "f", "cat": "fwdbwd", "id": 1, "tid": 2, "ts": 655},
    # device events and their launches
    K("blend_fwd_kernel", 120, 60, 1), L(115, 1),
    K("sm90_xmma_gemm", 290, 100, 2), L(275, 2),
    K("conv_dgrad", 620, 40, 3), L(610, 3, tid=2),
    K("mul_backward", 662, 10, 10), L(657, 10, tid=2),
    K("blend_bwd_kernel", 520, 50, 4), L(505, 4, tid=2),
    K("adam", 710, 60, 5), L(705, 5),
    K("Memcpy DtoH (Device -> Pageable)", 905, 5, 6, cat="gpu_memcpy"), L(902, 6),
    K("accumulate", 690, 10, 8), L(685, 8, tid=2),
    K("unlaunched", 990, 5, 99),
    K("densify", 1810, 20, 9), L(1805, 9),
    K("before the window", -500, 100, 11), L(-510, 11),
]
RENDER = "fit/train_step > system/loss > system/render"
GUIDANCE = "fit/train_step > system/loss > system/guidance"


def summary():
    return spans.reduce(EVENTS, SPANS)


def test_device_time_by_span():
    d = summary()["device_s"]
    assert d[RENDER] == pytest.approx(70e-6)  # its launch (60) and the flow-linked backward (10)
    assert d[GUIDANCE] == pytest.approx(140e-6)  # its launch and the sequence-linked backward
    assert d["render/backward"] == pytest.approx(50e-6)
    assert d["fit/train_step > system/backward"] == pytest.approx(10e-6)
    assert d["fit/train_step > system/update"] == pytest.approx(60e-6)
    assert d["fit/train_step > system/densify"] == pytest.approx(20e-6)
    assert d["fit/host_read"] == pytest.approx(5e-6)
    assert d["outside"] == pytest.approx(5e-6)
    assert sum(d.values()) == pytest.approx(360e-6)


def test_window_host_self_time_idle_and_counts():
    s = summary()
    assert s["steps"] == 2 and s["wall_s"] == pytest.approx(2e-3)
    assert s["busy_s"] == pytest.approx(360e-6)
    # train step self: 800 - 300 - 300 - 80 - 70, then 800 - 50
    assert s["host_self_s"]["fit/train_step"] == pytest.approx(800e-6)
    assert s["host_self_s"]["fit/train_step > system/loss"] == pytest.approx(40e-6)
    assert s["host_self_s"]["fit/data"] == pytest.approx(150e-6)  # 100 - 50, then 100
    assert s["host_self_s"]["fit/data > data/rays"] == pytest.approx(50e-6)
    # idle under the train step: 800 - 330 busy, then 800 - 20
    assert spans.under(s["idle_s"], ["fit/train_step"]) == pytest.approx(1250e-6)
    # the gap 380-390 is busy; 390-400 lies in system/loss's self
    assert s["idle_s"]["fit/train_step > system/loss > system/guidance"] == pytest.approx(
        (120 - 90) * 1e-6)  # 260-290 (the gemm runs 290-390)
    assert sum(s["idle_s"].values()) == pytest.approx(2e-3 - 360e-6)
    assert s["count"]["fit/host_read"] == 2
    assert s["count"][RENDER + " > render/host_read"] == 1
    assert s["count"]["render/backward"] == 1


def ctx():
    return {"spans": summary()}


@pytest.mark.parametrize("name,want", [
    ("render_ms", 0.06),  # (70 + 50) us over 2 steps
    ("guidance_ms", 0.07),
    ("update_ms", 0.04),  # (60 + 20) / 2
    ("step_idle_ms", 0.625),  # 1250 / 2
    ("host_reads", 1.5),  # 2 fit reads and the binning's, over 2 steps
])
def test_reader_values(name, want):
    assert metrics.reader(name)(ctx()) == pytest.approx(want)


def test_readers_without_spans_return_nothing():
    """A trace of a program without spans (an older checkout), and a run
    without a trace."""
    older = [e for e in EVENTS if e.get("name") not in SPANS]
    assert spans.reduce(older, SPANS) is None
    for c in ({"spans": None}, {"trace": None}):
        for name in ("render_ms", "guidance_ms", "update_ms", "step_idle_ms", "host_reads"):
            assert metrics.reader(name)(c) is None, name


def as_profiler_events(events, newer):
    """The canned trace as ``prof.events()`` gives it: each X event with its
    thread, time range, correlation, sequence number and forward thread;
    ``newer`` torch also gives its category and the flows on the ops they
    start or end at, an older one its device and annotation flag."""
    from types import SimpleNamespace as NS

    flows = {(e["tid"], e["ts"]): e for e in events if e.get("cat") == "fwdbwd"}
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a, f = e["args"], flows.get((e["tid"], e["ts"]))
        ev = NS(name=e["name"], thread=e["tid"], time_range=NS(start=e["ts"], end=e["ts"] + e["dur"]),
                id=a.get("correlation", 0), sequence_nr=a.get("Sequence number", -1),
                fwd_thread=a.get("Fwd thread id", 0))
        if newer:
            ev.activity_type, ev.flow_type = e["cat"], 1 if f else 0
            ev.flow_id, ev.flow_start = (f["id"], f["ph"] == "s") if f else (0, False)
        else:
            device = e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")
            ev.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
            ev.is_user_annotation = e["cat"] == "user_annotation"
        out.append(ev)
    return out


@pytest.mark.parametrize("newer", [True, False])
def test_readers_take_the_harness_profilers_events(newer):
    """Without ``ctx["spans"]``, the readers reduce the events of the
    profiler that the caller's frame holds as ``host["prof"]`` (a
    profiler's one chrome export is spent by the harness)."""

    class Prof:
        calls = 0

        def events(self):
            Prof.calls += 1
            return as_profiler_events(EVENTS, newer)

    def run():
        host = {"prof": Prof()}  # noqa: F841  (what the harness's run holds)
        c = {"trace": {"steps": 2}}
        return [metrics.reader(n)(c) for n in ("render_ms", "guidance_ms", "update_ms",
                                                "step_idle_ms", "host_reads")]

    assert run() == [pytest.approx(v) for v in (0.06, 0.07, 0.04, 0.625, 1.5)]
    assert Prof.calls == 1


class Older:
    """A profiler event without the fields newer torch adds (its category
    and its flow)."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        if name in ("activity_type", "flow_type", "flow_id", "flow_start"):
            raise AttributeError(name)
        return getattr(self._e, name)


@pytest.mark.parametrize("older", [False, True])
def test_profiler_events_reduce_as_their_chrome_export(tmp_path, older):
    """A CPU profile of a step with spans and a backward: its events (as
    newer or older torch gives them) and its chrome export give the same
    reduction."""
    import torch

    from threestudio_3dgs_tpu_torch.utils.tracing import span

    x = torch.randn(256, 256, requires_grad=True)
    sched = torch.profiler.schedule(wait=0, warmup=0, active=2, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                schedule=sched) as prof:
        for _ in range(2):
            with span("fit/train_step"):
                with span("system/loss"):
                    y = (x @ x).relu().sum()
                with span("system/backward"):
                    torch.autograd.grad(y, [x])
            prof.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    want = spans.read(str(path), SPANS)
    if older:
        events = [Older(e) for e in prof.events()]
        prof = type("Prof", (), {"events": lambda self: events})()
    got = spans.reduce(spans.profiler_events(prof, SPANS), SPANS)
    assert want["count"] == got["count"] == {"fit/train_step": 2,
                                             "fit/train_step > system/loss": 2,
                                             "fit/train_step > system/backward": 2}
    for k in ("steps", "wall_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    for p, v in want["host_self_s"].items():
        assert got["host_self_s"][p] == pytest.approx(v, rel=1e-4, abs=1e-8), p


def test_table_rows():
    rows = spans.table(summary())
    assert rows[0][0] == GUIDANCE and rows[0][1] == pytest.approx(0.07)
    assert sum(r[1] for r in rows) == pytest.approx(0.18)


def test_traced_harness_run_on_the_cpu_reports_the_span_counts():
    """The whole harness, traced, on the tiny SD cell on the CPU: the span
    readers find the harness's profiler and count the reads a step (the
    single pass's pair total, the live-row count, the 7 logged values);
    the device readers find no device events and report nothing."""
    import tempfile

    from benchmark import harness

    import tiny

    c = tiny.cell("sd21.t2i")
    with tempfile.TemporaryDirectory() as work:
        r = harness.run(c["name"], 20251019, 0.5, True, root=tiny.ROOT, device="cpu",
                        require_card=False, cell=c, log=lambda s: None, work_dir=work)
    assert r["metrics"]["host_reads"]["value"] == 9.0
    assert not {"render_ms", "guidance_ms", "update_ms", "step_idle_ms"} & set(r["metrics"])
