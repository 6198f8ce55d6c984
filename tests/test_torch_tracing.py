"""The port's spans (``utils/tracing.py``) on the CPU: a tiny ``fit`` under
a CPU ``torch.profiler`` emits every span of the training step, nested as
the module says, for each kind of system step (the base step, the
camera-sharded one, the zero123, 4D and SuGaR family); the spans inside
the guidance's models (the SD and the 4D step on tiny real weights), the
spacetime renderer's one timed evaluation a view and the 4D step's motion
regularisers; one ``*/host_read`` span for each device value the step
reads to the host; the rasterizer's hand backward on the thread that runs
autograd's nodes; and no ``record_function`` when no profiler records."""

import json
import os
import sys

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)
from test_torch_train import OVERRIDES, ROOT

from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils import tracing
from threestudio_3dgs_tpu_torch.utils.config import load_config


def config(name):
    return os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs", name + ".yaml")


SMALL = ["data.height=32", "data.width=32", "data.random_camera.height=32",
         "data.random_camera.width=32", "data.random_camera.batch_size=1",
         "system.geometry.init_num_pts=128", "system.geometry.capacity=512",
         "system.renderer.tile_size=16", "system.renderer.max_pairs=65536"]
# the step of each kind of system, at tiny sizes
STEPS = {
    "base": (config("gaussian_splatting"), OVERRIDES),
    "camera_sharded": (config("gaussian_splatting"), OVERRIDES + ["trainer.devices=1"]),
    "zero123": (config("gaussian_splatting_zero123"), SMALL + ["data.image_path="]),
    "gs4d": (config("gs4d_motion"), SMALL + ["data.video_length=3", "data.num_frames=3",
                                             "system.geometry.num_frames=4"]),
    "sugar": (config("gs_to_sugar"), SMALL + ["data.image_path="]),
}
# each span of the step: the spans it may open under (None: at the top of
# its thread); validation renders open system/render under fit/validate
PARENTS = {
    "fit/data": {None}, "data/rays": {"fit/data"}, "fit/train_step": {None},
    "fit/host_read": {None}, "fit/log": {None}, "fit/validate": {None},
    "fit/checkpoint": {None}, "system/loss": {"fit/train_step"},
    "system/render": {"system/loss", "fit/validate"}, "system/guidance": {"system/loss"},
    "render/host_read": {"system/render"},
    # autograd runs a CPU graph's nodes on the thread that asked for the
    # gradients, inside system/backward (a card's nodes on its own thread)
    "render/backward": {"system/backward"},
    "system/backward": {"fit/train_step"}, "system/host_read": {"system/loss", "system/densify"},
    "system/update": {"fit/train_step"}, "system/densify": {"fit/train_step"},
    "render/timed": {"system/render"}, "guidance/unet": {"system/guidance"},
    "guidance/encode": {"system/guidance"}, "system/motion_reg": {"system/loss"},
}
# the spans a kind of step has no occasion to open: the steps here guide
# with the fake or analytic guidances (no UNet, no encode), and only the 4D
# step renders a timed field and has motion regularisers
NO_MODELS = {"guidance/unet", "guidance/encode"}
STATIC = NO_MODELS | {"render/timed", "system/motion_reg"}
ABSENT = {"base": STATIC, "camera_sharded": STATIC, "zero123": STATIC, "gs4d": NO_MODELS,
          "sugar": STATIC | {"system/host_read"}}  # SuGaR's losses read no live-row count
READS = {"item", "__int__", "__float__", "__bool__", "__index__", "__format__", "tolist",
         "numpy", "__array__", "cpu"}
HOST_MADE = {"tensor", "as_tensor", "from_numpy"}


class DeviceReads(TorchFunctionMode):
    """Counts the calls of the train step and of ``fit``'s logging that
    read a device tensor's values on the host.  A tensor made from host
    data with no device named (the renderer's pair counts, ``torch.tensor``
    of Python ints), or computed from such tensors alone, is a host tensor,
    and a read's result is on the host: reading either reads nothing from
    the device.  Reads inside the kernels' plain twins (``*_torch``, which
    the card does not run) are not counted."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        read = name in READS and bool(inputs) and not getattr(inputs[0], "_on_host", False)
        if read:
            callers = [f.f_code.co_name for f in _frames(sys._getframe(1))]
            self.n += (any(c in ("train_step", "_host") for c in callers)
                       and not any(c.endswith("_torch") for c in callers))
        out = func(*args, **kwargs)
        if (read or (name in HOST_MADE and kwargs.get("device") is None)
                or (inputs and all(getattr(t, "_on_host", False) for t in inputs))):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    t._on_host = True
        return out


def _frames(frame):
    while frame is not None:
        yield frame
        frame = frame.f_back


def traced_fit(path, overrides, root, steps=2, count_reads=False):
    """``fit`` of ``steps`` steps under a CPU profiler: the trace's span
    events by name (with their parents' names and thread ids), the
    autograd node events, and the device reads counted."""
    cfg = load_config(path, list(overrides) + [
        f"exp_root_dir={root}", f"trainer.max_steps={steps}", "trainer.log_every_n_steps=1"])
    trainer = Trainer(cfg, device="cpu")
    reads = DeviceReads()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            if count_reads:
                with reads:
                    trainer.fit()
            else:
                trainer.fit()
    finally:
        trainer.close()
    trace = root / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return span_tree(events), [e for e in events if e.get("ph") == "X"
                               and str(e.get("name", "")).startswith("autograd::engine")], reads.n


def span_tree(events):
    """[(name, parent name or None, tid, ts, end)] of the program spans."""
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["tid"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"] in tracing.SPANS), key=lambda s: (s[0], -s[1]))
    out, stacks = [], {}
    for ts, end, name, tid in spans:
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None, tid, ts, end))
        stack.append((name, end))
    return out


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_every_step_opens_the_spans_nested(kind, tmp_path):
    path, overrides = STEPS[kind]
    extra = ["trainer.val_check_interval=2", "checkpoint.every_n_train_steps=2",
             "data.eval_height=32", "data.eval_width=32"]
    spans, _, _ = traced_fit(path, list(overrides) + extra, tmp_path)
    seen = {name for name, *_ in spans}
    assert set(tracing.SPANS) - ABSENT.get(kind, set()) <= seen, sorted(set(tracing.SPANS) - seen)
    for name, parent, *_ in spans:
        assert parent in PARENTS[name], (name, parent)


def spans_by_step(spans):
    """Each ``fit/train_step`` span's program spans: [{name: [parent, ...]}]."""
    steps = [(ts, end) for name, _, _, ts, end in spans if name == "fit/train_step"]
    out = []
    for t0, t1 in steps:
        inside = {}
        for name, parent, _, ts, _ in spans:
            if t0 < ts < t1:
                inside.setdefault(name, []).append(parent)
        out.append(inside)
    return out


def test_4d_step_opens_timed_guidance_and_motion_spans(tmp_path):
    """gs4d_motion on a tiny Stable Zero123 checkpoint: each step opens one
    ``render/timed`` a rendered view (3 frames, one random view a frame,
    and the 3 reference views) inside ``system/render``, the UNet's and the
    renders' encode once inside ``system/guidance``, and the motion
    regularisers once inside ``system/loss``."""
    from test_torch_zero123 import CLIP_DIM, TINY_UNET, TINY_VAE

    from threestudio_3dgs_tpu_torch.diffusion import convert

    ckpt = tmp_path / "z123" / "tiny.ckpt"
    os.makedirs(ckpt.parent)
    convert.write_random_ldm_checkpoint(str(ckpt), TINY_UNET, TINY_VAE, clip_dim=CLIP_DIM,
                                        seed=3, device="cpu")
    overrides = STEPS["gs4d"][1] + [
        "trainer.val_check_interval=0",
        f"system.guidance_zero123.pretrained_model_name_or_path={ckpt}",
        "system.guidance_zero123.half_precision_weights=false",
        "system.guidance_zero123.cond_image_size=32"]
    spans, _, _ = traced_fit(STEPS["gs4d"][0], overrides, tmp_path)
    steps = spans_by_step(spans)
    assert len(steps) == 2
    for inside in steps:
        assert inside["render/timed"] == ["system/render"] * (3 + 3)
        assert inside["guidance/unet"] == ["system/guidance"]
        assert inside["guidance/encode"] == ["system/guidance"]
        assert inside["system/motion_reg"] == ["system/loss"]


def test_sd_step_opens_unet_and_encode_under_guidance(tmp_path):
    """The base step on tiny SD weights (a UNet and a VAE encoder): the
    UNet's CFG call and the renders' encode open ``guidance/unet`` and
    ``guidance/encode`` once a step inside ``system/guidance``; the static
    renderer opens no ``render/timed``."""
    from threestudio_3dgs_tpu_torch.diffusion import convert, unet, vae

    ucfg = unet.UNet2DConditionConfig(
        block_out_channels=(32, 64), attention_head_dim=(2, 4), norm_groups=8,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
    vcfg = vae.AutoencoderKLConfig(block_out_channels=(16, 32), norm_groups=8)
    convert.write_random_checkpoint(str(tmp_path / "sd"), ucfg, vcfg, device="cpu")
    overrides = [o for o in OVERRIDES if not o.startswith("system.guidance")] + [
        "system.guidance_type=stable-diffusion-guidance",
        f"system.guidance.pretrained_model_name_or_path={tmp_path / 'sd'}",
        "system.guidance.half_precision_weights=false"]
    spans, _, _ = traced_fit(config("gaussian_splatting"), overrides, tmp_path)
    steps = spans_by_step(spans)
    assert len(steps) == 2
    for inside in steps:
        assert inside["guidance/unet"] == ["system/guidance"]
        assert inside["guidance/encode"] == ["system/guidance"]
        assert "render/timed" not in inside and "system/motion_reg" not in inside


@pytest.mark.parametrize("batched", [False, True])
def test_one_host_read_span_per_device_read(tmp_path, batched):
    """The base step at the tiny shape reads the binning's pair total (each
    view on the loop path, once on the single pass the YAMLs take), the
    live-row count and each logged loss; every one is a ``*/host_read``
    span, and nothing else reads the device."""
    overrides = OVERRIDES + (["system.renderer.batched=true"] if batched else [])
    spans, _, n_reads = traced_fit(config("gaussian_splatting"), overrides, tmp_path,
                                   count_reads=True)
    kinds = {}
    for name, *_ in spans:
        if name.endswith("/host_read"):
            kinds[name] = kinds.get(name, 0) + 1
    assert sum(kinds.values()) == n_reads
    assert kinds["render/host_read"] == 2 * (1 if batched else 2)  # 2 steps of 2 views
    assert kinds["system/host_read"] == 2
    assert kinds["fit/host_read"] == 2 * 7  # the 7 logged losses a step


def test_render_backward_runs_in_autograd_nodes(tmp_path):
    """Each ``render/backward`` span lies inside the autograd engine's run
    of the blend's or the pair gather's node, on that node's thread."""
    spans, nodes, _ = traced_fit(config("gaussian_splatting"), OVERRIDES, tmp_path, steps=1)
    backward = [s for s in spans if s[0] == "render/backward"]
    assert len(backward) == 2 * 2  # 2 views: the blend's and the gather's
    for _, _, tid, ts, end in backward:
        assert any(n["tid"] == tid and float(n["ts"]) <= ts and end <= float(n["ts"]) + n["dur"]
                   and n["name"].endswith(("BlendBackward", "PairGatherBackward"))
                   for n in nodes)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def no_call(name):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_call)
    first, second = tracing.span("fit/data"), tracing.span("system/render")
    assert first is second
    with first:
        assert tracing.host_read(torch.tensor(3)) == 3


def test_span_under_a_profiler_is_recorded():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("system/update"):
            assert tracing.host_read(torch.tensor([2.5]), "fit/host_read") == 2.5
    names = [e.name for e in prof.events()]
    assert "system/update" in names and "fit/host_read" in names
