#!/usr/bin/env python3
"""The random-camera sampler's rays built on the card (``device_rays`` in
``threestudio_3dgs_tpu_torch/data/uncond.py``), checked on one CUDA card
for the data blocks of ``gaussian_splatting.yaml`` (4 views at 512^2) and
``gaussian_splatting_mvdream.yaml`` (4 at 256^2), as written:

    python3 scripts/check_device_rays.py [--steps 20]

For each YAML and each of ``--steps`` steps, ``train_batch`` of the data
module built on the card runs under
``torch.cuda.set_sync_debug_mode("error")``, so a blocking copy or read of
the card raises; its rays are held to ``rays_from_c2w`` on the same draws
to 1e-6 with TF32 matmuls allowed; the sampler must count only card
builds.  Then it prints, for the same module built on the card and on the
host, the median host ms of a ``train_batch`` (what the benchmark's
``data_ms`` times) and the device ms a batch that ``torch.profiler``
records.  Exits non-zero
on any failure.  Imports no JAX."""

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from threestudio_3dgs_tpu_torch.data.uncond import rays_from_c2w  # noqa: E402
from threestudio_3dgs_tpu_torch.utils import tracing  # noqa: E402
from threestudio_3dgs_tpu_torch.utils.config import load_config  # noqa: E402
from threestudio_3dgs_tpu_torch.utils.registry import find  # noqa: E402

YAMLS = ("gaussian_splatting", "gaussian_splatting_mvdream")


def module(name, device):
    cfg = load_config(os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs",
                                   name + ".yaml"), [])
    return find(cfg.data_type)(cfg.data, seed=20, device=device)


def check(name, steps, device):
    data = module(name, device)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        batches = [data.train_batch(step) for step in range(steps)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    worst = 0.0
    for batch in batches:
        want = rays_from_c2w(batch["c2w"], batch["fovy"], batch["height"], batch["width"],
                             data.cfg.rays_d_normalize)
        for k, w in zip(("rays_o", "rays_d"), want):
            got = batch[k]
            if not (isinstance(got, torch.Tensor) and got.device.type == "cuda"
                    and got.dtype == torch.float32 and tuple(got.shape) == w.shape):
                raise AssertionError(f"{name}: {k} is {type(got)} {getattr(got, 'shape', '')}")
            np.testing.assert_allclose(got.cpu().numpy(), w, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name}: {k}")
            worst = max(worst, float(np.abs(got.cpu().numpy() - w).max()))
    builds = data.train_sampler.ray_builds
    if builds != {"device": steps, "host": 0}:
        raise AssertionError(f"{name}: ray_builds {builds}")
    b, h, w = batches[0]["c2w"].shape[0], batches[0]["height"], batches[0]["width"]
    print(f"[rays] {name}: {steps} train_batch calls at {b} x {h} x {w} under sync debug "
          f"mode 'error': no blocking copy or read; rays to rays_from_c2w: max |gap| {worst:.3g}; "
          f"ray_builds {builds}", flush=True)


def timed(name, steps, device):
    data = module(name, device)
    for step in range(3):  # the first builds make the pixel grid and warm the allocators
        data.train_batch(step)
    host_ms = []
    for step in range(3, steps + 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        data.train_batch(step)
        host_ms.append((time.perf_counter() - t) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for step in range(steps + 3, 2 * steps + 3):
            data.train_batch(step)
        torch.cuda.synchronize()
    # the device's own rows (kernels, copies): an op's row repeats its kernels'
    # time, and a span's device row covers its whole interval
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.key) for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and e.key not in tracing.SPANS), reverse=True)
    where = "card" if device is not None else "host"
    print(f"[rays] {name}: rays on the {where}: train_batch host ms median "
          f"{statistics.median(host_ms):.3f} (min {min(host_ms):.3f}, max {max(host_ms):.3f}); "
          f"device ms a batch (profiler) {sum(ms for ms, _ in rows):.4f}"
          + "".join(f"; {key[:60]} {ms:.4f}" for ms, key in rows[:4]), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this check runs on the card")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[rays] {card or torch.cuda.get_device_name(device)}, torch {torch.__version__}",
          flush=True)
    for name in YAMLS:
        check(name, args.steps, device)
    for name in YAMLS:
        timed(name, args.steps, device)
        timed(name, args.steps, None)


if __name__ == "__main__":
    main()
