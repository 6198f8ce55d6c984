"""Where the time goes on the card (port of the JAX package's
``utils/profiling.py`` idea: a device trace of the hot path).

    python -m threestudio_3dgs_tpu_torch.utils.profiling [--steps 3] [--trace-dir DIR]
        [--sd-dir DIR | --config YAML [key=value ...]]

Profiles, with ``torch.profiler`` (CPU and CUDA activities), these windows:

  * ``train``: training steps of ``configs/gaussian_splatting.yaml`` at the
    config's own shape (512^2, B=4, fake SDS guidance) after two warm-up
    steps;
  * ``render``: forward+backward ``rasterize`` of bench.py's scene (1M
    Gaussians, 512^2, tile 32, seed 0);
  * with ``--sd-dir``: ``train_sd``, the same steps with the YAML's own
    stable-diffusion-guidance on that diffusers directory (a seeded random
    SD 2.1-base one is written there first if it holds no weights), and
    its two guidance stages alone on the step's shapes: ``sd_unet`` (one
    UNet call on the CFG batch of 8) and ``sd_vae`` (VAE encode of the 4
    views, forward and backward);
  * with ``--config`` instead of the above: ``train_<config name>``, the
    training steps of that YAML with the given overrides (e.g. a guidance
    or prompt-processor directory, the material's warm-up); for the 4D
    system (``gs4d*.yaml``) also its two substeps alone, each a forward
    and backward on the step's shapes: ``<name>_zero123`` (the random
    views' renders and the temporal Zero123 SDS) and ``<name>_ref`` (the
    reference frames' renders and their losses).

For each window it prints the wall time per iteration (host clock around
work that ends in a synchronise, without and with the profiler), for the
training step the host-side camera sampler's share, the device-busy share (the sum of kernel
and copy times over the window's wall time; one stream, so nothing
overlaps), the device time per kernel family and the top kernels.  Needs
a CUDA device.

It also holds the scenes, kernel inputs and card-against-CPU checks that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` share, and the
counterparts of the JAX package's ``utils/profiling.py``:
``device_trace`` (the launcher's ``--profile``: a ``torch.profiler``
trace of the first training steps, which ``read_trace`` reads back),
``time_fn`` and ``StepTimer``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler
from torch.utils._pytree import tree_leaves

# kernel-name patterns -> family, first match wins
FAMILIES = [
    ("K1 blend forward", r"blend_fwd_kernel"),
    ("K2 blend backward", r"blend_bwd_kernel"),
    ("K3 segmented sum", r"segsum_kernel"),
    ("K4 expand", r"expand_kernel"),
    ("K5 flash attention", r"flash_fwd_(wgmma|split)|split_planes"),
    # cuDNN's NCHW <-> NHWC transposes around each convolution
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


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_kernels(prof) -> Dict[str, float]:
    """Device microseconds by kernel name of a profiler's window."""
    kernels: Dict[str, float] = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    return kernels


def summarize(kernels: Dict[str, float], wall_s: float, iters: int) -> Dict[str, object]:
    """Device time per kernel family and the top kernels of one window, from
    its device microseconds by kernel name."""
    families: Dict[str, float] = {}
    for name, us in kernels.items():
        fam = next((f for f, pat in FAMILIES if re.search(pat, name)), "other")
        families[fam] = families.get(fam, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {
        "iters": iters,
        "wall_ms_per_iter": wall_s * 1e3 / iters,
        "device_ms_per_iter": busy_ms / iters,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "families_ms_per_iter": {
            k: v / 1e3 / iters for k, v in sorted(families.items(), key=lambda kv: -kv[1])
        },
        "top_kernels_ms_per_iter": [(k[:90], v / 1e3 / iters) for k, v in top],
    }


def wall_ms(fn: Callable[[], None], iters: int) -> float:
    """Host-clock time per call, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_window(fn: Callable[[], None], iters: int, trace_path: str = "") -> Dict:
    """Unprofiled wall time per call, then one profiled window."""
    unprofiled = wall_ms(fn, iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"wall_ms_per_iter_unprofiled": unprofiled,
            **summarize(device_kernels(prof), wall, iters)}


# the window of device_trace, in training steps: the first step skipped (the
# kernels' build, the allocator's warm-up), one step of warm-up, then
# TRACE_ACTIVE recorded; the profiler dropped the records of long windows on
# the card's machine, so the rest of the run is not traced
TRACE_WAIT, TRACE_WARMUP, TRACE_ACTIVE = 1, 1, 3
TRACE_STEPS = TRACE_WAIT + TRACE_WARMUP + TRACE_ACTIVE  # the steps that complete the window
# the event categories of device work in a chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """A ``torch.profiler`` trace of the first training steps, written under
    ``logdir`` by TensorBoard's handler (``*.pt.trace.json``): CPU activity,
    and CUDA activity when ``device`` is a CUDA device.  Yields the
    profiler, whose ``step()`` the caller calls once a training step.  The
    trace is written when the window's last step ends, or when the profiler
    stops inside the window (in a ``finally``: an exception in the block
    still propagates); a block that ends before the window records
    nothing."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   schedule=schedule(wait=TRACE_WAIT, warmup=TRACE_WARMUP, active=TRACE_ACTIVE,
                                     repeat=1),
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def read_trace(logdir: str) -> Dict[str, Any]:
    """The newest trace ``device_trace`` wrote under ``logdir``: its path,
    its events, its recorded profiler steps (the ``ProfilerStep#N``
    annotations), their summed wall seconds and the device microseconds by
    kernel name."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    with open(paths[-1]) as fh:
        events = json.load(fh)["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")]
    kernels: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    return {"path": paths[-1], "events": events,
            "steps": sorted({e["name"] for e in steps}),
            "wall_s": sum(float(e.get("dur", 0.0)) for e in steps) / 1e6,
            "kernels": kernels}


def _wait(out) -> None:
    """Wait for the device work behind the tensors of ``out`` (the CPU's
    is done when a call returns)."""
    for device in {t.device for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, iters: int = 8, warmup: int = 1,
            vary: Optional[Callable[[int], tuple]] = None) -> Dict[str, float]:
    """Wall time of ``fn(*args)`` (of ``fn(*vary(i))`` with ``vary``): the
    first call alone (``compile_s``: the kernels' build, the allocator's
    warm-up), ``warmup - 1`` more, then ``iters`` calls back to back with
    one synchronise of the outputs' device after them (``ms`` a call)."""
    t0 = time.perf_counter()
    _wait(fn(*(vary(0) if vary else args)))
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _wait(fn(*(vary(0) if vary else args)))
    t0 = time.perf_counter()
    outs = [fn(*(vary(i + 1) if vary else args)) for i in range(iters)]
    _wait(outs)
    ms = (time.perf_counter() - t0) / iters * 1000.0
    return {"ms": ms, "compile_s": compile_s}


class StepTimer:
    """Per-step wall timing of a training loop, dumped as jsonl."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: List[Dict[str, Any]] = []
        self._t = time.perf_counter()

    def lap(self, step: int, **extra) -> Dict[str, Any]:
        now = time.perf_counter()
        row = {"step": step, "ms": (now - self._t) * 1000.0, **extra}
        self._t = now
        self.rows.append(row)
        return row

    def dump(self) -> None:
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                for row in self.rows:
                    f.write(json.dumps(row) + "\n")


def lookat_c2w(eye) -> np.ndarray:
    """OpenGL-convention camera-to-world of a camera at `eye` looking at the
    origin with +z up (bench.py's camera)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return c2w


def bench_scene(device) -> Dict[str, object]:
    """bench.py's scene: 1M Gaussians in a ball, seed 0, one 512^2 view at
    tile 32; the rasterize inputs by name."""
    from ..ops import camera as cam_ops

    n = 1_000_000
    rng = np.random.default_rng(0)
    arrays = dict(
        means=rng.normal(size=(n, 3)).astype(np.float32) * 0.35,
        scales=np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 5.2),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.2, 0.9, size=(n,)).astype(np.float32),
        colors=rng.uniform(size=(n, 3)).astype(np.float32),
    )
    scene: Dict[str, object] = {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}
    scene.update(
        cam=cam_ops.camera_from_c2w(lookat_c2w([0.0, -2.5, 0.5]), 0.9, 0.9, 512, 512,
                                    device=device),
        alive=None, tile_size=32,
    )
    return scene


def render_step(scene: Dict[str, object]) -> Callable[[], tuple]:
    """Forward+backward rasterize of `scene` (as bench.py measures it); the
    step returns the render's outputs and the gradients of its leaves."""
    from ..ops.rasterizer import RasterizeConfig, rasterize

    leaves = [scene[k].detach().clone().requires_grad_(True)
              for k in ("means", "scales", "quats", "opac", "colors")]
    bg = torch.zeros(3, device=leaves[0].device)
    config = RasterizeConfig(tile_size=scene["tile_size"])

    def step():
        out = rasterize(*leaves[:4], scene["cam"], bg, colors=leaves[4],
                        alive=scene["alive"], config=config)
        loss = out["image"].sum() + out["alpha"].sum() + out["depth"].sum()
        return out, torch.autograd.grad(loss, leaves)

    return step


# the render's kernels (K1-K4), by their names in native.LAUNCHES, and each
# one's symbol in csrc/ (what a device trace names it by)
RASTER_KERNELS = ("blend_forward", "blend_backward", "segsum_monotone", "expand_bin")
RASTER_SYMBOLS = dict(zip(RASTER_KERNELS, ("blend_fwd_kernel", "blend_bwd_kernel",
                                           "segsum_kernel", "expand_kernel")))


def k5_inputs(bh: int, n: int, dtype: torch.dtype, seed: int, device="cuda",
              rising: bool = False, d: int = 64) -> List[torch.Tensor]:
    """q, k, v of shape (bh, n, d), standard normal drawn in f32 from
    ``seed`` on ``device`` and cast to ``dtype``.  ``rising``: key j is
    scaled by 0.1 + 9.9 j / (n - 1), so the keys come in rising norm, the
    logits (at scale 1/8, d = 64) span about +-30 and a row's running max
    grows from key tile to key tile (every tile rescales)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=device) for _ in range(3))
    if rising:
        k = k * torch.linspace(0.1, 10.0, n, device=device)[:, None]
    return [t.to(dtype) for t in (q, k, v)]


def k5_float64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K5's function evaluated in float64 (``flash_bhnd_torch``'s
    arithmetic: p rounded to the input type before p . v), returned in
    float64: the value the f32 check holds K5 to at keys in rising norm,
    where the plain twin in f32 is itself up to 2.5e-5 from it on the card
    (cuBLAS's f32 rounding of the +-240 raw scores)."""
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype).double(), v.double()) / p.sum(dim=-1, keepdim=True)


def k5_tolerance(want: torch.Tensor) -> float:
    """Largest |K5 - plain| accepted on the same inputs.  bf16: 2^-6 of
    max|plain|, two bf16 ulps at the largest output (the two differ only in
    the max that shifts p before p is rounded, and in the output's own
    rounding; one ulp on an H100), where a kernel that skipped any one key
    tile (64 or 128 keys) is off by more than 10x that (a CPU model of K5's
    arithmetic in tests/test_torch_flash_attention.py).  f32: 2e-5, the
    JAX test's."""
    if want.dtype == torch.bfloat16:
        return 2.0**-6 * float(want.float().abs().max())
    return 2e-5


# the tiny SD directory of the card-against-CPU check: head dim 64 at level
# 0, so its 32^2 = 1024-token self-attention meets the routing rule
TINY_SD_UNET = dict(block_out_channels=(64, 128), attention_head_dim=(1, 2), cross_attention_dim=48,
                    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), norm_groups=8)
TINY_SD_VAE = dict(block_out_channels=(16, 32), norm_groups=8)
TINY_SD_K5_LAUNCHES = 5  # 2 down + 3 up transformer blocks at level 0


def tiny_sd_card_vs_cpu(root: str, seed: int = 0) -> Dict[str, tuple]:
    """Write a seeded random tiny SD directory at ``root`` and run the SD
    guidance (f32 weights) on it on the card and on the CPU with the same
    rgb, embedding and draws.  Returns, per device ("cuda", "cpu"), the SDS
    loss, its gradient w.r.t. rgb (on the CPU) and the K5 launches."""
    from ..diffusion import convert, unet, vae
    from ..guidance.stable_diffusion import StableDiffusionGuidance
    from ..ops import native

    convert.write_random_checkpoint(root, unet.UNet2DConditionConfig(**TINY_SD_UNET),
                                    vae.AutoencoderKLConfig(**TINY_SD_VAE), seed=seed,
                                    device="cpu")
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    emb = rng.normal(size=(77, TINY_SD_UNET["cross_attention_dim"])).astype(np.float32)
    draws = {"t": torch.tensor([100, 800]),
             "noise": torch.tensor(rng.normal(size=(2, 4, 32, 32)).astype(np.float32)),
             "latent_noise": torch.tensor(rng.normal(size=(2, 4, 32, 32)).astype(np.float32))}

    class Prompt:
        def get_text_embeddings(self, elevation=None, azimuth=None):
            return emb

    results = {}
    for device in ("cuda", "cpu"):
        guidance = StableDiffusionGuidance({"pretrained_model_name_or_path": root,
                                            "half_precision_weights": False}, device=device)
        x = torch.tensor(rgb, device=device, requires_grad=True)
        native.reset_launches()
        out = guidance(x, Prompt(), {}, draws=draws)
        out["loss_sds"].backward()
        results[device] = (float(out["loss_sds"].detach()), x.grad.cpu(),
                           native.LAUNCHES["flash_attention_forward"])
    return results


# the tiny Zero123 checkpoint of the card-against-CPU check: 320 channels
# and ZERO123_UNET's 8 heads at level 0 (d = 40, Stable Zero123's), so its
# 32^2 = 1024-token self-attention meets the routing rule and runs K5 at
# d = 40; the 2-level VAE takes the 64^2 conditioning size to 32^2
TINY_ZERO123_UNET = dict(in_channels=8, block_out_channels=(320, 320), attention_head_dim=(8, 8),
                         cross_attention_dim=32, use_linear_projection=False,
                         down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                         up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
TINY_ZERO123_K5_LAUNCHES = 5  # 2 down + 3 up transformer blocks at level 0


def tiny_zero123_card_vs_cpu(root: str, seed: int = 0) -> Dict[str, tuple]:
    """Write a seeded random tiny ldm ``.ckpt`` under ``root`` and run the
    Zero123 guidance (f32 weights, conditioning size 64, the stand-in CLIP
    embeddings) on it on the card and on the CPU: ``prepare_embeddings`` on
    one frame, then one call on two renders with the same draws.  Returns,
    per device ("cuda", "cpu"), the SDS loss, its gradient w.r.t. rgb (on
    the CPU) and the K5 launches of the call."""
    from ..diffusion import convert, unet, vae
    from ..guidance.temporal_zero123 import StableZero123Guidance
    from ..ops import native

    path = os.path.join(root, "zero123-tiny.ckpt")
    convert.write_random_ldm_checkpoint(path, unet.UNet2DConditionConfig(**TINY_ZERO123_UNET),
                                        vae.AutoencoderKLConfig(**TINY_SD_VAE),
                                        clip_dim=TINY_ZERO123_UNET["cross_attention_dim"],
                                        seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    frame = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    rgb = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    batch = {"elevation": np.array([20.0, -5.0], np.float32),
             "azimuth": np.array([40.0, 200.0], np.float32),
             "camera_distances": np.array([3.8, 3.8], np.float32)}
    draws = {"t": torch.tensor([300, 900]),
             "noise": torch.tensor(rng.normal(size=(2, 4, 32, 32)).astype(np.float32)),
             "latent_noise": torch.tensor(rng.normal(size=(2, 4, 32, 32)).astype(np.float32))}
    results = {}
    for device in ("cuda", "cpu"):
        guidance = StableZero123Guidance({"pretrained_model_name_or_path": path,
                                          "half_precision_weights": False,
                                          "cond_image_size": 64, "cond_elevation_deg": 5.0,
                                          "cond_camera_distance": 3.8}, device=device)
        guidance.prepare_embeddings(frame)
        x = torch.tensor(rgb, device=device, requires_grad=True)
        native.reset_launches()
        out = guidance(x, None, batch, draws=draws)
        out["loss_sds"].backward()
        results[device] = (float(out["loss_sds"].detach()), x.grad.cpu(),
                           native.LAUNCHES["flash_attention_forward"])
    return results


DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                              "gaussian_splatting.yaml")


def train_step(device, run_dir: str, config: str = DEFAULT_CONFIG,
               overrides=("system.guidance_type=fake-sds-guidance",)) -> Callable[[], None]:
    """One training step of ``config`` at its own shape with its
    ``overrides`` (by default gaussian_splatting.yaml with fake guidance)."""
    from ..trainer import Trainer
    from ..utils.config import load_config

    cfg = load_config(config, list(overrides) + [
        f"exp_root_dir={run_dir}", "trainer.val_check_interval=0",
    ])
    trainer = Trainer(cfg, device=device)
    trainer.state = trainer.system.init_state(cfg.seed)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    counter = {"step": 0}

    def step():
        batch = trainer.data.train_batch(counter["step"])
        trainer.state, logs = trainer.system.train_step(
            trainer.state, batch, counter["step"], generator)
        float(logs["train/loss_total"].detach())  # the per-step host read fit() makes
        counter["step"] += 1

    step.data_batch = lambda: trainer.data.train_batch(counter["step"])
    step.trainer = trainer
    return step


def sd_stages(trainer) -> Dict[str, Callable[[], object]]:
    """The SD guidance's two stages alone, at the training step's shapes:
    one UNet call on the CFG batch (2B latents) and the VAE encode of the B
    views with its backward."""
    guidance = trainer.system.guidance
    data = trainer.cfg.data
    b, h, w = data["batch_size"], data["height"], data["width"]
    device = trainer.device
    gen = torch.Generator(device=device).manual_seed(0)
    rgb = torch.rand((b, h, w, 3), generator=gen, device=device, requires_grad=True)
    with torch.no_grad():
        latents = guidance.encode_rgb(rgb, gen)
    t = torch.full((b,), 500, device=device)
    batch = trainer.data.train_batch(0)
    emb = torch.as_tensor(trainer.system.prompt_utils.get_text_embeddings(
        batch["elevation"], batch["azimuth"]), device=device)
    return {
        "sd_unet": lambda: guidance.denoiser(latents, t, emb),
        "sd_vae": lambda: torch.autograd.grad(guidance.encode_rgb(rgb, gen).sum(), rgb),
    }


def substeps_4d(trainer, name: str) -> Dict[str, Callable[[], object]]:
    """The 4D system's two substeps alone on the first batch's shapes, each
    a forward and a backward to the field's parameters."""
    system, state = trainer.system, trainer.state
    batch = trainer.data.train_batch(0)
    sched = system.sched_scalars(0)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.gauss.params.as_dict().items()}
    gs = dataclasses.replace(state.gauss, params=dataclasses.replace(state.gauss.params, **leaves))
    inputs = list(leaves.values())

    def zero123():
        rcb = batch["random_camera"]
        out = system.render_batch(gs, state.extra_params, rcb, gen, sched, True)
        g = system.guidance(out["comp_rgb"], system.prompt_utils, rcb, generator=gen,
                            sched=sched.get("guidance"))
        torch.autograd.grad(g["loss_sds"], inputs, allow_unused=True)

    def ref():
        out = system.render_batch(gs, state.extra_params, batch, gen, sched, True)
        torch.autograd.grad(system._ref_losses(out, batch, sched, {}), inputs, allow_unused=True)

    return {f"{name}_zero123": zero123, f"{name}_ref": ref}


def main(argv: List[str] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--run-dir", default=os.path.join("outputs", "profile"))
    parser.add_argument("--trace-dir", default="", help="write chrome traces here")
    parser.add_argument("--sd-dir", default="", help="also profile SD guidance on this directory")
    parser.add_argument("--config", default="",
                        help="profile only the training step of this config")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides of --config")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    device = torch.device("cuda")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    windows = [("train", lambda: train_step(device, args.run_dir)),
               ("render", lambda: render_step(bench_scene(device)))]
    if args.config:
        name = "train_" + os.path.splitext(os.path.basename(args.config))[0]
        windows = [(name, lambda: train_step(device, args.run_dir, args.config, args.overrides))]
    elif args.sd_dir:
        from ..diffusion.convert import write_random_checkpoint

        if not os.path.exists(os.path.join(args.sd_dir, "unet", "diffusion_pytorch_model.bin")):
            write_random_checkpoint(args.sd_dir, seed=0, device=device)
        windows.append(("train_sd", lambda: train_step(
            device, args.run_dir,
            overrides=[f"system.guidance.pretrained_model_name_or_path={args.sd_dir}"])))
    results = {}
    while windows:
        name, make = windows.pop(0)
        fn = make()
        for _ in range(2):
            fn()
        trace = os.path.join(args.trace_dir, f"{name}.json") if args.trace_dir else ""
        results[name] = profile_window(fn, args.steps, trace)
        if hasattr(fn, "data_batch"):  # the host-side camera sampler alone
            results[name]["data_batch_ms"] = wall_ms(fn.data_batch, args.steps)
        print(f"[profile] {name}: {json.dumps(results[name])}", flush=True)
        if name == "train_sd":
            windows.extend((stage, lambda f=f: f) for stage, f in sd_stages(fn.trainer).items())
        if name.startswith("train_gs4d"):
            windows.extend((stage, lambda f=f: f)
                           for stage, f in substeps_4d(fn.trainer, name[len("train_"):]).items())
        del fn
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
