"""K1 and K2 (``csrc/blend.cu``) of one tree of the port, timed alone on the
card, for comparing two trees in turns on one card:

    PYTHONPATH=TREE python3 threestudio_3dgs_tpu_torch/utils/blend_timing.py [--iters 50]

``TREE`` is the root of the tree whose package (and so whose kernels) is
timed; the script itself may come from another tree, and uses only what
every tree of the port has had since its first slice.  The inputs are the
same in every tree: bench.py's scene (1M Gaussians, 512^2, tile 32, seed 0)
and one view of ``gaussian_splatting.yaml``'s initial field (the config's
seed, ``train_batch(0)``'s first camera, tile 32), each with a standard
normal cotangent of the blend output (seeded).  Prints the card's name and
power limit, then one JSON line: per input the pair count and the mean
time of one ``blend_forward_cuda`` / ``blend_backward_cuda`` call (CUDA
events over ``--iters`` calls after a warm-up), wrappers included.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

import threestudio_3dgs_tpu_torch as port


def train_view_scene(run_dir: str, device="cuda"):
    """One camera of the YAML's first training batch over its initial field."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.ops import camera as cam_ops
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors
    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    config = os.path.join(os.path.dirname(port.__file__), "configs", "gaussian_splatting.yaml")
    cfg = load_config(config, ["system.guidance_type=fake-sds-guidance", f"exp_root_dir={run_dir}"])
    trainer = Trainer(cfg, device=device)
    gauss = trainer.system.init_state(cfg.seed).gauss
    batch = trainer.data.train_batch(0)
    fovy = float(batch["fovy"][0])
    cam = cam_ops.camera_from_c2w(batch["c2w"][0], fovy, fovy, int(batch["height"]),
                                  int(batch["width"]), device=device)
    p = gauss.params
    with torch.no_grad():
        colors = sh_colors(p.xyz, gf.get_features(p), cam.campos, 0)
        return dict(means=p.xyz, scales=gf.get_scaling(p), quats=p.rotation,
                    opac=gf.get_opacity(p)[:, 0], colors=colors, cam=cam, alive=gauss.alive,
                    tile_size=trainer.system.renderer.cfg.tile_size)


def blend_inputs(scene, seed: int, device="cuda"):
    """K1's and K2's inputs for one view, as ``rasterize`` makes them."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import binning, preprocess

    cam, ts = scene["cam"], scene["tile_size"]
    gx, gy = (cam.width + ts - 1) // ts, (cam.height + ts - 1) // ts
    with torch.no_grad():
        proj = preprocess.project_gaussians(scene["means"], scene["scales"], scene["quats"], cam,
                                            ts, alive=scene["alive"])
        bins = binning.bin_gaussians(proj, gx, gy, 2**21, ts, scene["opac"])
        channels = torch.cat([scene["colors"], proj.depths[:, None]], dim=1)
        feats = torch.cat([proj.means2d, proj.conics, scene["opac"][:, None], channels], dim=1)
        pair_feats = feats[bins.pair_gauss].contiguous()
        gen = torch.Generator(device=device).manual_seed(seed)
        g_out = torch.randn((gx * gy, ts * ts, channels.shape[1] + 1), generator=gen,
                            device=device)
    if bins.n_dropped:
        raise RuntimeError(f"{bins.n_dropped} pairs dropped")
    return pair_feats, bins.tile_ranges, g_out, (gx, gy, ts, channels.shape[1])


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--run-dir", default=os.path.join("outputs", "blend_timing"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("blend timing needs a CUDA device")
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend
    from threestudio_3dgs_tpu_torch.utils.profiling import bench_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    result = {"package": os.path.dirname(port.__file__), "inputs": {}}
    for name, make in (("train", lambda: train_view_scene(args.run_dir)),
                       ("bench", lambda: bench_scene("cuda"))):
        pf, ranges, g_out, dims = blend_inputs(make(), seed=2)
        with torch.no_grad():
            out = blend.blend_forward_cuda(pf, ranges, *dims)
            result["inputs"][name] = {
                "pairs": int(pf.shape[0]),
                "k1_ms": time_ms(lambda: blend.blend_forward_cuda(pf, ranges, *dims), args.iters),
                "k2_ms": time_ms(lambda: blend.blend_backward_cuda(pf, ranges, out, g_out, *dims),
                                 args.iters),
            }
        del pf, ranges, g_out, out
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
