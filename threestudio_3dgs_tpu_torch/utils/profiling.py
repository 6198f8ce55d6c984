"""The launcher's device trace, and the scenes, kernel inputs and
card-against-CPU checks that ``chip_smoke.py`` and ``tests/test_torch_gpu.py``
share.

``device_trace`` (the launcher's ``--profile``, the counterpart of the JAX
package's ``jax.profiler`` trace) records the first training steps of
``fit`` with ``torch.profiler`` (CPU and CUDA activities); ``read_trace``
reads the trace back.  The trace holds the program's spans
(``utils/tracing.py``) beside the CPU ops and the kernels, on one clock:
``benchmark/spans.py`` reduces it by span (device ms, host self ms, idle
ms).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

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
# the projection's kernel pair (K7), the same way
PROJECT_KERNELS = ("project_fwd", "project_bwd")
PROJECT_SYMBOLS = dict(zip(PROJECT_KERNELS, ("project_fwd_kernel", "project_bwd_kernel")))
# the hand kernels' families in a device trace, by symbol (first match wins);
# ``benchmark/trace.py`` keeps its own copy, where K7 falls under "other"
FAMILIES = [
    ("K1 blend forward", r"blend_fwd_kernel"),
    ("K2 blend backward", r"blend_bwd_kernel"),
    ("K3 segmented sum", r"segsum_kernel"),
    ("K4 expand", r"expand_kernel"),
    ("K5 flash attention", r"flash_fwd_(wgmma|split)|split_planes"),
    ("K7 project", r"project_(fwd|bwd)_kernel"),
]

# K7's inputs at the cells' shapes: (field rows, live rows, views, view size);
# the live rows come first, as the trainer's capacity layout keeps them
PROJECT_SHAPES = {
    "gs4d": (651_024, 4_096, 1, 256),  # gs4d.motion: one view a pass (groups of one)
    "sd": (651_024, 4_096, 4, 512),  # sd21.t2i: the single pass over 4 views
    "mv": (131_024, 4_096, 4, 256),  # mvdream.t2i
}


def project_scene(device, rows: int, live: int, views: int, size: int,
                  seed: int = 0) -> Dict[str, Any]:
    """A field of ``rows`` rows whose first ``live`` are alive (Gaussians in
    a ball, 1-4 tiles across at tile 32), ``views`` cameras of ``size``^2 on
    a ring around it: ``project``'s inputs by name, and ``cams``."""
    from ..ops import camera as cam_ops

    rng = np.random.default_rng(seed)
    arrays = dict(
        means=rng.normal(size=(rows, 3)).astype(np.float32) * 0.35,
        scales=np.exp(rng.normal(size=(rows, 3)).astype(np.float32) * 0.3 - 3.5),
        quats=rng.normal(size=(rows, 4)).astype(np.float32),
        opac=rng.uniform(0.05, 0.95, size=(rows,)).astype(np.float32),
    )
    scene: Dict[str, Any] = {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}
    scene["alive"] = torch.arange(rows, device=device) < live
    scene["cams"] = [cam_ops.camera_from_c2w(
        lookat_c2w([2.5 * np.sin(2 * np.pi * v / views), -2.5 * np.cos(2 * np.pi * v / views),
                    0.3 + 0.1 * v]), 0.9, 0.9, size, size, device=device) for v in range(views)]
    return scene


def project_vs_twin(device, case: str, seed: int) -> Dict[str, float]:
    """K7 (``project_fwd_cuda`` / ``project_bwd_cuda``) against its plain
    twins at ``PROJECT_SHAPES[case]``, with a means2d offset and standard
    normal upstream gradients drawn from ``seed``: ``exact``, the elements
    of the integer outputs, counts and sort keys that differ; ``floats``,
    the largest gap of means2d, depths, conics and cull fields over each
    column's largest; ``grads``, of each gradient over its largest;
    ``dead``, the nonzero gradients of dead rows; ``nonfinite``, of every
    gradient; and the rows ``visible`` and ``masked`` and the ``pairs``."""
    from ..ops.rasterizer import project as k7
    from ..ops.rasterizer.expand import MASK_NONE

    rows, live, b, size = PROJECT_SHAPES[case]
    scene = project_scene(device, rows, live, b, size, seed=seed)
    views = k7.ProjectViews(tuple(scene["cams"]), 32, 1.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    offset = torch.randn((b, rows, 2) if b > 1 else (rows, 2), generator=gen, device=device)
    args = (scene["means"], scene["scales"], scene["quats"], scene["opac"], scene["alive"],
            offset * 0.01)
    with torch.no_grad():
        (got_p, got_r), (want_p, want_r) = (fn(*args, views) for fn in (
            k7.project_fwd_cuda, k7.project_fwd_torch))
    exact = sum(int((got != want).sum()) for got, want in (
        *((getattr(got_p, k), getattr(want_p, k)) for k in ("radii", "tiles_min", "tiles_max",
                                                             "visible")),
        *((getattr(got_r, k), getattr(want_r, k)) for k in ("rect", "counts", "sort_key"))))
    floats = max(float(((got - want).abs().amax(0) / want.abs().amax(0).clamp_min(1e-30)).max())
                 for got, want in ((got_p.means2d, want_p.means2d),
                                   (got_p.depths[:, None], want_p.depths[:, None]),
                                   (got_p.conics, want_p.conics),
                                   (got_r.cull_fields, want_r.cull_fields)))
    upstream = [torch.randn(shape, generator=gen, device=device)
                for shape in ((b * rows, 2), (b * rows,), (b * rows, 3))]
    bwd = (scene["means"], scene["scales"], scene["quats"], scene["alive"], views, *upstream,
           True)
    got_g, want_g = k7.project_bwd_cuda(*bwd), k7.project_bwd_torch(*bwd)
    return dict(
        exact=exact, floats=floats,
        grads=max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got_g, want_g)),
        dead=sum(int(g[:, live:].count_nonzero()) for g in got_g),
        nonfinite=sum(int((~torch.isfinite(g)).sum()) for g in got_g),
        visible=int(got_p.visible.sum()), masked=int((got_r.rect[:, 3] != MASK_NONE).sum()),
        pairs=int(got_r.counts.sum()))


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
