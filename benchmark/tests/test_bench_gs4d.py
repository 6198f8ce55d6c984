"""The ``zero123-4d`` kind (``gs4d.motion``) at tiny sizes on the CPU: a
Zero123-shaped UNet (8 input channels, 1x1-convolution projections, one
context token), a CLIP image tower of two layers and 32^2 frames.  The
plain reference agrees with the port's CPU path, also with the lite
ARAP's weight above 0 from the first step; the fp8 control and the
planted faults turn ``correct`` false; ``model_seconds`` matches
PyTorch's ``FlopCounterMode`` and a hand count; the weight sets keep their
names and bytes; the new readers give known values on a canned trace."""

from __future__ import annotations

import copy
import os
import tempfile

import pytest
import torch

from benchmark import harness

UNET = dict(block_out_channels=[32, 64], attention_head_dim=8, norm_num_groups=32,
            cross_attention_dim=24, down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"])
VAE = dict(block_out_channels=[16, 32], norm_num_groups=16)
CLIP = dict(hidden_size=32, intermediate_size=64, projection_dim=24, num_hidden_layers=2,
            num_attention_heads=4, image_size=16, patch_size=4)
SIZE = 32
OVERRIDES = [f"data.height={SIZE}", f"data.width={SIZE}", f"data.random_camera.height={SIZE}",
             f"data.random_camera.width={SIZE}", "data.video_length=4", "data.num_frames=4",
             "system.geometry.init_num_pts=256", "system.geometry.max_num=1000",
             "system.guidance_zero123.half_precision_weights=false",
             f"system.guidance_zero123.cond_image_size={SIZE}"]


def tiny_cell(extra=()):
    """``gs4d.motion`` at tiny sizes (its limits kept)."""
    c = copy.deepcopy(harness.load_cell("gs4d.motion"))
    config = c["config"]
    config["name"] = "tiny-" + config["name"]
    config["unet"].update(UNET)
    config["vae"].update(VAE)
    config["image_encoder"].update(CLIP)
    config["clip_camera_projection"].update(in_channel=CLIP["projection_dim"] + 4,
                                            out_channel=CLIP["projection_dim"])
    config["cond_image_size"] = SIZE
    c["traffic"]["overrides"] = c["traffic"]["overrides"] + OVERRIDES + list(extra)
    return c


def run(c, seed=20251022, seconds=0.5, trace=False, log=lambda s: None, **kw):
    """The harness on the CPU, its weights and run directory in a fresh
    temporary directory."""
    with tempfile.TemporaryDirectory() as work:
        return harness.run(c["name"], seed, seconds, trace, root=os.path.dirname(harness.BENCH_DIR),
                           device="cpu", require_card=False, cell=c, log=log, work_dir=work, **kw)


# the tiny cell's limits: the f32 program against the f32 reference on the
# CPU measured at most 1.6e-5 (loss, with the lite ARAP on), 2.4e-6 (grad),
# 1.1e-5 (change) and 6e-6 (change_median) over these tests' seeds; the fp8
# control read 5.8e-4 / 6.8e-4 / 2.6e-4 and the 10% answer 3.9e-3 (loss), so
# 1e-4 leaves 6x room above the program and 2.6x below the control.  (The
# cell's own limits are set for the bf16 program at published widths.)
TINY_LIMITS = {"loss": 1e-4, "grad": 1e-4, "change": 1e-4, "change_median": 1e-4}


def tiny_limited(extra=()):
    c = tiny_cell(extra)
    c["cell"]["limits"] = dict(TINY_LIMITS)
    return c


def test_cell_files_agree():
    """The cell runs gs4d_motion.yaml with the Zero123 guidance the
    configuration names, its weights read from the harness's directory."""
    import yaml

    c = harness.load_cell("gs4d.motion")
    with open(os.path.join(os.path.dirname(harness.BENCH_DIR), c["traffic"]["yaml"])) as f:
        yml = yaml.safe_load(f)
    assert yml["system"]["guidance_zero123_type"] == c["config"]["guidance"]
    assert ("system.guidance_zero123.pretrained_model_name_or_path="
            "${system.guidance.pretrained_model_name_or_path}") in c["traffic"]["overrides"]
    assert c["cell"]["chips"] == 1 and set(c["cell"]["limits"]) <= {"loss", "grad", "change",
                                                                      "change_median"}


@pytest.mark.parametrize("arap", [False, True])
def test_reference_follows_program_cpu(arap):
    """The f32 program against the reference, with the real denoiser built
    from the weight set (and, with ``arap``, the lite ARAP weighted 1000
    from the first step, so that its term is compared too)."""
    built = []
    res = run(tiny_limited(["system.loss.lambda_lite_arap_reg=1000."] if arap else []),
              fault=lambda trainer: built.append(trainer.system.guidance.unet is not None))
    assert built == [True]
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("case", ["control", "unchanged_state", "half_batch", "altered_answer"])
def test_control_and_faults_turn_correct_false(case):
    from benchmark import faults

    kw = {"control": True} if case == "control" else {"fault": faults.FAULTS[case]}
    res = run(tiny_limited(), **kw)
    assert not res["correct"], res["compared"]


def test_traced_run_counts_the_timed_evaluations():
    """A traced CPU run: one ``render/timed`` a rendered view (4 frames, 2
    random views a frame, 4 reference views); the device readers find no
    device events and report nothing."""
    res = run(tiny_limited(), trace=True)
    assert res["metrics"]["timed_evals"]["value"] == 4 * 2 + 4
    assert not {"timed_ms", "unet_ms", "vae_encode_ms", "motion_reg_ms"} & set(res["metrics"])


def test_inputs_are_seeded_frames_the_program_reads():
    """The kind's frames: the same for a seed, others for another; the
    port's data module and the reference read the same pixels and masks."""
    import numpy as np

    from benchmark import kinds
    from benchmark.reference import video4d

    from threestudio_3dgs_tpu_torch.data.temporal_image import TemporalImageDataModule

    c = tiny_cell()
    kind = kinds.load(c)
    with tempfile.TemporaryDirectory() as d:
        over = kind.inputs(c, 5, d)
        directory = over[0].partition("=")[2]
        rgb, mask = video4d.load_frames(directory, 4, SIZE)
        data = TemporalImageDataModule({"video_frames_dir": directory, "video_length": 4,
                                        "num_frames": 4, "height": SIZE, "width": SIZE}, seed=0)
        np.testing.assert_array_equal(data.rgbs, rgb)
        np.testing.assert_array_equal(data.masks, mask)
    assert 0.05 < mask.mean() < 0.6 and np.abs(np.diff(mask, axis=0)).sum() > 0
    a, b = kind.frames(5, 4, SIZE), kind.frames(6, 4, SIZE)
    assert (a == kind.frames(5, 4, SIZE)).all() and not (a == b).all()


# (seed) -> (the set's directory name, sha256 of its files' names and bytes)
SETS = {0: ("tiny-stable-zero123-set0-90ec6126315f2c11", "dfdd39cc567c682e"),
        1: ("tiny-stable-zero123-set1-84e0c2bc95465304", "0733b74ae4f9438f")}
FULL = {0: "stable-zero123-set0-88ce585271f74c52", 1: "stable-zero123-set1-c430667fdee9ad07"}


@pytest.mark.parametrize("seed", sorted(SETS))
def test_weight_sets_keep_names_and_bytes(tmp_path, seed):
    from test_bench_kinds import files_digest

    from benchmark import kinds, weights

    c = tiny_cell()
    path, _ = weights.ensure(str(tmp_path), c["config"], seed, torch.device("cpu"),
                             kinds.load(c).weight_files(c["config"]))
    assert (os.path.basename(path), files_digest(path)) == SETS[seed]
    assert sorted(os.listdir(path)) == ["clip_camera_projection", "complete", "image_encoder",
                                        "unet", "vae"]
    assert os.listdir(os.path.join(path, "image_encoder")).count("pytorch_model.bin") == 1
    full = harness.load_cell("gs4d.motion")
    files = kinds.load(full).weight_files(full["config"])
    assert os.path.basename(weights.weight_dir("", full["config"], seed, files)) == FULL[seed]
    # the published widths: 859.5M in the UNet, 304.0M in the image tower
    import math

    params = {f["name"]: sum(math.prod(s) for s in f["shapes"].values()) for f in files}
    assert params == {"unet": 859532484, "vae": 34163664, "image_encoder": 303966208,
                      "clip_camera_projection": 593664}


def _counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_model_seconds_match_counter():
    """``model_seconds`` of the tiny configuration against PyTorch's count
    of the reference's UNet forward on the CFG batch of 6 guided views
    (cond_image_size / 8 latents, one context token) and the VAE encoder's
    forward and backward to the input on the views: every product at the
    bf16 peak but conv_out and quant_conv, at the convolutions' peak."""
    from benchmark import costs, kinds
    from benchmark.reference import diffusion

    c = tiny_cell()
    config = c["config"]
    gen = torch.Generator().manual_seed(0)

    def weights(shapes):
        return {k: torch.randn(s, generator=gen) * 0.1 for k, s in shapes.items()}

    b, s, lat = 6, SIZE, SIZE // 8
    unet_w, vae_w = weights(diffusion.unet_shapes(config["unet"])), weights(
        diffusion.vae_encoder_shapes(config["vae"]))
    unet = _counted(lambda: diffusion.unet_forward(
        unet_w, config["unet"], torch.randn(2 * b, 8, lat, lat), torch.randint(0, 1000, (2 * b,)),
        torch.randn(2 * b, 1, 24)))
    x = torch.randn(b, 3, s, s, requires_grad=True)
    vae = _counted(lambda: diffusion.vae_encode(vae_w, config["vae"], x))
    y = diffusion.vae_encode(vae_w, config["vae"], x)
    vae += _counted(lambda: torch.autograd.grad(y.sum(), x))
    c0, lat_c = config["unet"]["block_out_channels"][0], 4
    unet_out = 2 * 2 * b * c0 * 4 * 9 * lat * lat
    h = s // 2  # the tiny VAE downsamples once
    vae_out = 2 * (2 * b * 32 * 2 * lat_c * 9 * h * h + 2 * b * (2 * lat_c) ** 2 * h * h)
    for cudnn in (True, False):
        peak = costs.PEAK_TF32 if cudnn else costs.PEAK_F32
        want = ((unet - unet_out + vae - vae_out) / costs.PEAK_BF16
                + (unet_out + vae_out) / peak)
        ctx = {"batch": {"random_camera": {"c2w": torch.zeros(b, 4, 4).numpy()}}}
        got = kinds.load(c).model_seconds(config, ctx, {"cudnn_tf32": cudnn, "matmul_tf32": False})
        assert got == pytest.approx(want, rel=1e-12)


def test_zero123_unet_flops_by_hand():
    """One level of a Zero123-shaped UNet (8 input channels, 1x1-conv
    projections, one context token), no up/down sampling: the sum written
    out."""
    from benchmark import costs

    cfg = {"block_out_channels": [8], "attention_head_dim": 2, "cross_attention_dim": 6,
           "layers_per_block": 1, "down_block_types": ["CrossAttnDownBlock2D"],
           "up_block_types": ["CrossAttnUpBlock2D"], "use_linear_projection": False,
           "in_channels": 8, "norm_num_groups": 2}
    b, n, c, L, cross, temb = 2, 4, 8, 1, 6, 32
    conv3 = lambda cin, cout: 2 * b * cin * cout * 9 * n  # noqa: E731
    resnet = lambda cin, cout: (conv3(cin, cout) + conv3(cout, cout)  # noqa: E731
                                + 2 * b * temb * cout
                                + (2 * b * cin * cout * n if cin != cout else 0))
    transformer = (2 * 2 * b * n * c * c  # proj_in, proj_out as 1x1 convolutions
                   + 4 * 2 * b * n * c * c + 2 * 2 * b * n * c * c + 2 * 2 * b * L * cross * c
                   + 2 * b * n * c * 8 * c + 2 * b * n * 4 * c * c
                   + 4 * b * n * n * c + 4 * b * n * L * c)
    hand = (2 * b * (c * temb + temb * temb) + conv3(8, c)
            + resnet(c, c) + transformer + resnet(c, c) + transformer + resnet(c, c)
            + 2 * (resnet(2 * c, c) + transformer) + conv3(c, 4))
    flops = costs.unet_flops(cfg, b, 2, 2, L)
    assert sum(flops.values()) == hand
    assert flops["conv"] > flops["dense"]  # the projections count as convolutions


# ---------------------------------------------------------------------------
# The new readers on a canned trace (times in us; main thread 1, autograd's 2)
# ---------------------------------------------------------------------------


def X(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid, "args": args}


def K(name, ts, dur, corr):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": "kernel", "tid": 7,
            "args": {"correlation": corr}}


def L(ts, corr, tid=1):
    return X("cudaLaunchKernel", ts, 2, cat="cuda_runtime", tid=tid, correlation=corr)


EVENTS = [
    X("ProfilerStep#4", 0, 1000), X("ProfilerStep#5", 1000, 1000),
    X("fit/train_step", 100, 800), X("system/loss", 100, 400),
    X("system/render", 110, 90), X("render/timed", 115, 10), X("render/timed", 130, 10),
    X("system/guidance", 210, 190), X("guidance/encode", 215, 45), X("guidance/unet", 270, 120),
    X("system/motion_reg", 410, 70), X("system/backward", 500, 300),
    X("aten::convolution", 221, 5, cat="cpu_op", **{"Sequence number": 7, "Fwd thread id": 0}),
    X("ConvolutionBackward0", 600, 50, cat="cpu_op", tid=2,
      **{"Sequence number": 7, "Fwd thread id": 1}),
    K("timed_mul", 120, 4, 1), L(116, 1), K("timed_add", 135, 4, 2), L(131, 2),
    K("blend_fwd_kernel", 150, 40, 3), L(145, 3),
    K("conv_fprop", 230, 20, 4), L(222, 4), K("conv_dgrad", 610, 30, 5), L(605, 5, tid=2),
    K("sm90_gemm", 280, 100, 6), L(272, 6), K("arap_sum", 420, 10, 7), L(412, 7),
    X("fit/train_step", 1100, 800), X("system/loss", 1100, 400), X("system/render", 1110, 90),
    X("render/timed", 1115, 10), X("render/timed", 1130, 10),
    K("timed_mul", 1118, 4, 8), L(1116, 8),
]
NEW = {"timed_ms": 12e-3 / 2, "timed_evals": 2.0, "vae_encode_ms": 50e-3 / 2,
       "unet_ms": 100e-3 / 2, "motion_reg_ms": 10e-3 / 2}


def test_new_readers_on_a_canned_trace():
    """Each new metric's value by hand; ``render_ms`` and ``guidance_ms``
    still sum every path through their spans (the timed evaluations inside
    the render, the encode with its linked backward and the UNet inside the
    guidance)."""
    from benchmark import metrics, spans
    from threestudio_3dgs_tpu_torch.utils.tracing import SPANS

    ctx = {"spans": spans.reduce(EVENTS, SPANS)}
    for name, want in NEW.items():
        assert metrics.reader(name)(ctx) == pytest.approx(want), name
    assert metrics.reader("render_ms")(ctx) == pytest.approx((4 + 4 + 40 + 4) * 1e-3 / 2)
    assert metrics.reader("guidance_ms")(ctx) == pytest.approx((20 + 30 + 100) * 1e-3 / 2)


def test_new_readers_without_the_spans_return_nothing():
    """A program that opens none of the new spans (the parent checkout):
    the new readers give None and the older ones still read."""
    from benchmark import metrics, spans
    from threestudio_3dgs_tpu_torch.utils.tracing import SPANS

    older = [e for e in EVENTS if e["name"] not in ("render/timed", "guidance/encode",
                                                    "guidance/unet", "system/motion_reg")]
    ctx = {"spans": spans.reduce(older, SPANS)}
    for name in NEW:
        assert metrics.reader(name)(ctx) is None, name
        assert metrics.reader(name)({"spans": None}) is None, name
    assert metrics.reader("render_ms")(ctx) == pytest.approx((4 + 4 + 40 + 4) * 1e-3 / 2)
