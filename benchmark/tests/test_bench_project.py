"""The projection's readers (``project_ms``, ``project_calls``) on a canned
trace: one render whose projection launches one kernel under
``system/render`` > ``render/project``, and its backward on autograd's
thread under ``render/backward`` > ``render/project``; times in us, two
recorded steps."""

import pytest

from test_bench_gs4d import K, L, X


EVENTS = [
    X("ProfilerStep#4", 0, 1000), X("ProfilerStep#5", 1000, 1000),
    X("fit/train_step", 100, 800), X("system/loss", 100, 400),
    X("system/render", 110, 90), X("render/project", 112, 6), K("project_fwd_kernel", 120, 3, 1),
    L(113, 1), K("blend_fwd_kernel", 150, 40, 2), L(145, 2),
    X("system/backward", 500, 300),
    X("render/backward", 600, 40, tid=2), X("render/project", 620, 10, tid=2),
    K("project_bwd_kernel", 640, 5, 3), L(622, 3, tid=2),
    K("blend_bwd_kernel", 700, 20, 4), L(605, 4, tid=2),
]


def test_project_readers_on_a_canned_trace():
    from benchmark import metrics, spans

    ctx = {"spans": spans.reduce(EVENTS, spans.program_spans())}
    assert metrics.reader("project_ms")(ctx) == pytest.approx((3 + 5) * 1e-3 / 2)
    assert metrics.reader("project_calls")(ctx) == pytest.approx(2 / 2)
    # render_ms still counts the projection both ways
    assert metrics.reader("render_ms")(ctx) == pytest.approx((3 + 40 + 5 + 20) * 1e-3 / 2)


def test_project_readers_without_the_span_return_nothing():
    """A program that opens no ``render/project`` (the parent checkout)."""
    from benchmark import metrics, spans

    older = [e for e in EVENTS if e["name"] != "render/project"]
    for ctx in ({"spans": spans.reduce(older, spans.program_spans())}, {"spans": None}):
        for name in ("project_ms", "project_calls"):
            assert metrics.reader(name)(ctx) is None, name
