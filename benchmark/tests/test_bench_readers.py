"""The trace reduction and the per-layer readers on a small canned trace
of two recorded steps, with the values worked out by hand."""

import pytest

from benchmark import costs, metrics, trace

import tiny


def X(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


EVENTS = [
    X("ProfilerStep#4", 0, 1000, "cpu_op"), X("ProfilerStep#5", 1000, 1000, "cpu_op"),
    X("bench.data_batch", 0, 90, "user_annotation"),
    X("bench.train_step", 90, 810, "user_annotation"),
    X("bench.logged_reads", 900, 100, "user_annotation"),
    X("aten::item", 940, 50, "cpu_op"),
    X("bench.data_batch", 1000, 300, "user_annotation"),
    X("bench.train_step", 1300, 600, "user_annotation"),
    X("blend_fwd_kernel", 100, 100, "kernel"),
    X("Memcpy DtoH (Device -> Pageable)", 300, 50, "gpu_memcpy"),
    X("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", 320, 80, "kernel"),
    X("sm90_xmma_fprop_implicit_gemm", 1400, 200, "kernel"),
    X("void flash_fwd_wgmma<1>", 1650, 100, "kernel"),
    X("before the window", -500, 100, "kernel"),
]


def summary():
    return trace.summarize(EVENTS)


def test_summary():
    s = summary()
    assert s["steps"] == 2 and s["wall_s"] == pytest.approx(2e-3)
    # busy: 100-200, 300-400 (copy and gemm overlap), 1400-1600, 1650-1750
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["families"]["copy DtoH"] == pytest.approx(50e-6)
    assert s["families"]["conv / matmul (library)"] == pytest.approx(280e-6)
    # the gaps 0-90 (data batch), 90-100, 200-300 and 400-900 (train step), 900-1000
    # (logged reads, in aten::item at its middle), 1000-1300 (data batch), 1300-1400,
    # 1600-1650 (train step), 1750-2000 (outside a span)
    assert s["gaps"]["data_batch"] == pytest.approx(90e-6 + 300e-6)
    assert s["gaps"]["logged_reads:aten::item"] == pytest.approx(100e-6)
    assert sum(s["gaps"].values()) == pytest.approx(2e-3 - 500e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "conv / matmul (library)" and len(b["idle_gaps"]) <= 10


def ctx():
    cell = tiny.cell("sd21.t2i")
    return {"cell": cell, "trace": summary(), "data_ms": [240.0, 260.0],
            "k5_launches": {"40x4096x64": 1}, "flags": {"cudnn_tf32": True, "matmul_tf32": False},
            "card": {"sm_hz": 1.98e9}, "batch_shape": (4, 512, 512), "step_s_untraced": 0.5}


@pytest.mark.parametrize("name,want", [
    ("data_ms", 250.0),
    ("host_reads_ms", 0.025),
    ("raster_kernels_ms", 0.05),
    ("raster_sort_ms", 0.0),
    ("diffusion_lib_ms", 0.14),
    ("device_idle_share", 75.0),
    ("k5_roofline", 100.0 * costs.k5_bound_s(40, 4096, 64, "bf16")[0] / 100e-6),
])
def test_reader_values(name, want):
    assert metrics.reader(name)(ctx()) == pytest.approx(want)


def test_mfu_by_hand():
    c = ctx()
    cfg = c["cell"]["config"]
    u = costs.unet_flops(cfg["unet"], 8, 64, 64, 77)
    v = costs.vae_encoder_flops(cfg["vae"], 4, 512, 512)
    bf16 = sum(u.values()) - u["conv_out"] + 2 * (v["conv"] + v["dense"]) + 3 * v["attn"]
    f32 = u["conv_out"] + 2 * v["conv_out"]
    want = 100 * (bf16 / 989e12 + f32 / 495e12) / 0.5
    assert metrics.reader("mfu")(c) == pytest.approx(want)


def test_readers_without_a_trace_return_nothing():
    c = {"cell": tiny.cell("sd21.t2i"), "data_ms": [], "flags": {}}
    for name in ("data_ms", "host_reads_ms", "raster_kernels_ms", "raster_sort_ms",
                 "diffusion_lib_ms", "k5_roofline", "device_idle_share", "mfu"):
        assert metrics.reader(name)(c) is None, name
