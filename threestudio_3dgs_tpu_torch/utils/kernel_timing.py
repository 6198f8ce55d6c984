"""K1-K7 (``csrc/blend.cu``, ``csrc/segsum.cu``, ``csrc/expand.cu``,
``csrc/flash_attention.cu``, ``csrc/project.cu``) of one tree of the port,
timed alone on the card, for comparing two trees in turns on one card:

    PYTHONPATH=TREE python3 threestudio_3dgs_tpu_torch/utils/kernel_timing.py [--iters 50]

``TREE`` is the root of the tree whose package (and so whose kernels) is
timed; the script itself may come from another tree, and calls only
``PairPlan.expand``, ``segsum_inputs``, ``profiling.bench_scene``,
``profiling.k5_inputs`` and the six ``*_cuda`` wrappers, which the trees
it compares share with the same signatures.  The inputs are the same in
every tree: bench.py's scene (1M Gaussians, 512^2, tile 32, seed 0)
and one view of ``gaussian_splatting.yaml``'s initial field (the config's
seed, ``train_batch(0)``'s first camera, tile 32), each with a standard
normal cotangent of the blend output (seeded); K3's rows are the pair
gradients K2 makes from it, as a backward sorts them.

K7 (``project_fwd_cuda`` / ``project_bwd_cuda``) at the three cells'
shapes of ``profiling.PROJECT_SHAPES`` (651,024 rows of which 4,096 live
at one 256^2 view and at 4 x 512^2; 131,024 at 4 x 256^2), beside the
plain path it replaced (skipped, and said so, for a tree without K7).

K6 (``expand_slots_cuda``) at the bench scene's depth-ordered pair
offsets (max_pairs the pair total rounded up to 512), beside
``torch.searchsorted``.  Then K5 at the UNet's two bf16 self-attention
shapes, (40, 4096, 64) and (80, 1024, 64), at MVDream's two f32 ones,
(10, 4096, 64) and (20, 1024, 64), at Stable Zero123's (64, 1024, 40) and
(320, 1024, 40) and at its wider head dims, (64, 1024, 80) and
(64, 1024, 160) (skipped, and said so, for a tree whose K5 refuses them),
beside ``scaled_dot_product_attention``;
for f32 also, over 8 seeds of keys in rising norm (the f32 check's
hardest inputs; the limit is 2e-5), the largest |K5 - plain twin|,
|K5 - float64| and |plain twin - float64|, with TF32 off.

For each input and kernel it prints two clocks of one call, each over
``--iters`` back-to-back calls: ``ms``, the wrapper time (CUDA events,
host work included), and ``device_ms``, the device time (one CUDA graph
of the calls replayed between CUDA events: every kernel the call
launches, no host work between them).  For K3, K5 and K6 the same two
clocks of the library call that computes their function
(``torch.segment_reduce``, ``scaled_dot_product_attention``,
``torch.searchsorted``) as ``library_ms`` and ``library_device_ms``.
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
device.

``chip_smoke.py`` takes its clocks from here (``wrapper_ms``,
``graph_ms``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Dict

import torch

import threestudio_3dgs_tpu_torch as port


def wrapper_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean time of one call over `iters` back-to-back calls, CUDA events
    (the host's work between launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean time of one call in a CUDA graph of `iters` calls, replayed
    between two CUDA events: the device's time with no host work between
    the launches (every kernel of the call, fills included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_call(call, iters: int, prefix: str = "") -> Dict[str, float]:
    """The call's wrapper and device (graph replay) times."""
    return {f"{prefix}ms": wrapper_ms(call, iters), f"{prefix}device_ms": graph_ms(call, iters)}


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


def view_inputs(scene, seed: int, device="cuda", max_pairs: int = 2**21, cameras=None,
                tile_band=None):
    """K1-K4's inputs for one view, as ``rasterize`` makes them: the pair
    plan, K1's and K2's pair rows (rgb, depth and the scene's ``extra``
    features where it has them), ranges and cotangent, and K3's rows,
    offsets and counts from K2's pair gradients.  With ``cameras`` (B > 1
    of one size) the inputs of ``rasterize_batched``'s single pass: the B
    views' Gaussians on the grid of the views stacked as tile rows,
    ``view_grid_y`` the tile rows of a view (0 for one view).  With
    ``tile_band`` (row0, rows) the inputs of one band of the view, as
    ``rasterize(tile_band=...)`` makes them."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import binning, blend, preprocess
    from threestudio_3dgs_tpu_torch.ops.rasterizer.api import band_projection

    cams = list(cameras) if cameras else [scene["cam"]]
    b, ts = len(cams), scene["tile_size"]
    gx, gy = (cams[0].width + ts - 1) // ts, (cams[0].height + ts - 1) // ts
    if tile_band is not None:
        gy = tile_band[1]
    vgy = gy if b > 1 else 0
    # the stacked grid's argument only where there is one: a tree from
    # before the batched render is timed through the same calls
    grid = (vgy,) if vgy else ()
    with torch.no_grad():
        projs, chans = [], []
        for v, cam in enumerate(cams):
            proj = preprocess.project_gaussians(scene["means"], scene["scales"], scene["quats"],
                                                cam, ts, alive=scene["alive"])
            if tile_band is not None:
                proj = band_projection(proj, tile_band[0], tile_band[1], ts)
            shift = torch.tensor([0, v * gy], dtype=proj.tiles_min.dtype, device=device)
            projs.append(proj._replace(tiles_min=proj.tiles_min + shift,
                                       tiles_max=proj.tiles_max + shift))
            chans.append(torch.cat([scene["colors"], proj.depths[:, None]]
                                   + ([scene["extra"]] if scene.get("extra") is not None else []),
                                   dim=1))
        proj = preprocess.Projected(*(torch.cat(x, dim=0) for x in zip(*projs)))
        opac = scene["opac"].repeat(b)
        plan = binning.plan_pairs(proj, gx, b * gy, max_pairs, ts, opac, *grid)
        bins = binning.bin_gaussians(proj, gx, b * gy, max_pairs, ts, opac, *grid)
        channels = torch.cat(chans, dim=0)
        feats = torch.cat([proj.means2d, proj.conics, opac[:, None], channels], dim=1)
        pair_feats = feats[bins.pair_gauss].contiguous()
        gen = torch.Generator(device=device).manual_seed(seed)
        dims = (gx, b * gy, ts, channels.shape[1])
        g_out = torch.randn((gx * b * gy, ts * ts, channels.shape[1] + 1), generator=gen,
                            device=device)
        out = blend.blend_forward_cuda(pair_feats, bins.tile_ranges, *dims, *grid)
        d_pairs = blend.blend_backward_cuda(pair_feats, bins.tile_ranges, out, g_out, *dims,
                                            *grid)
        seg = binning.segsum_inputs(bins, d_pairs)
    if bins.n_dropped:
        raise RuntimeError(f"{bins.n_dropped} pairs dropped")
    return dict(plan=plan, bins=bins, pair_feats=pair_feats, out=out, g_out=g_out, seg=seg,
                dims=dims, view_grid_y=vgy)


def kernel_calls(inp):
    """name -> (the kernel's wrapper call, the library call or None)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend, expand, segsum

    pf, out, g_out, dims = (inp[k] for k in ("pair_feats", "out", "g_out", "dims"))
    grid = (inp["view_grid_y"],) if inp.get("view_grid_y") else ()
    ranges = inp["bins"].tile_ranges
    vals, offs, counts = inp["seg"]
    return {
        "blend_forward": (lambda: blend.blend_forward_cuda(pf, ranges, *dims, *grid), None),
        "blend_backward": (
            lambda: blend.blend_backward_cuda(pf, ranges, out, g_out, *dims, *grid), None),
        "segsum_monotone": (
            lambda: segsum.segsum_cuda(vals, offs, counts),
            lambda: torch.segment_reduce(vals, "sum", lengths=counts, axis=0, unsafe=True)),
        "expand_bin": (lambda: inp["plan"].expand(expand.expand_bin_cuda), None),
    }


# K7's bytes a row (csrc/project.cu): every row reads its mean and alive
# flag and writes every output; a live row also reads its scale, quaternion
# and opacity (forward) or its scale, quaternion and six upstream gradients
# (backward)
PROJECT_ROW_BYTES = {"project_fwd": (13 + 97, 32), "project_bwd": (13 + 40, 52)}
HBM_BYTES_PER_S = 3.35e12


def project_rows(iters: int) -> Dict[str, Dict[str, float]]:
    """K7's forward and backward at the cells' shapes (``PROJECT_SHAPES``),
    each beside the plain path it replaced on the card (``plain_ms``, the
    wrapper time of the forward twin, ``project_gaussians`` and the plain
    row pass a view, or of autograd's backward through it), with the bound
    by bytes.  A tree without K7 gives nothing."""
    try:
        from threestudio_3dgs_tpu_torch.ops.rasterizer import project as k7
        from threestudio_3dgs_tpu_torch.utils.profiling import PROJECT_SHAPES, project_scene
    except ImportError as e:
        print(f"K7: not in this tree ({e})", flush=True)
        return {}

    out = {}
    for name, (rows, live, b, size) in PROJECT_SHAPES.items():
        sc = project_scene("cuda", rows, live, b, size)
        views = k7.ProjectViews(tuple(sc["cams"]), 32, 1.0)
        gen = torch.Generator(device="cuda").manual_seed(rows + b)
        grads = [torch.randn(shape, generator=gen, device="cuda")
                 for shape in ((b * rows, 2), (b * rows,), (b * rows, 3))]
        args = (sc["opac"], sc["alive"], None, views)
        with torch.no_grad():
            # the wrapper's time with the camera table's build, as a render
            # makes it; the device's, of the kernel alone
            fwd = dict(ms=wrapper_ms(lambda: k7.project_fwd_cuda(
                sc["means"], sc["scales"], sc["quats"], *args[:3],
                k7.ProjectViews(views.cameras, 32, 1.0)), iters),
                device_ms=graph_ms(lambda: k7.project_fwd_cuda(
                    sc["means"], sc["scales"], sc["quats"], *args), iters))
            bwd = time_call(lambda: k7.project_bwd_cuda(
                sc["means"], sc["scales"], sc["quats"], sc["alive"], views, *grads, False), iters)
            fwd["plain_ms"] = wrapper_ms(lambda: k7.project_fwd_torch(
                sc["means"], sc["scales"], sc["quats"], *args), iters)
        leaves = [sc[k].detach().clone().requires_grad_(True) for k in ("means", "scales", "quats")]
        proj, _ = k7.project_fwd_torch(*leaves, *args)
        loss = (proj.means2d * grads[0]).sum() + (proj.depths * grads[1]).sum() \
            + (proj.conics * grads[2]).sum()
        bwd["plain_ms"] = wrapper_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
                                     iters)
        for kernel, row in (("project_fwd", fwd), ("project_bwd", bwd)):
            every, live_only = PROJECT_ROW_BYTES[kernel]
            row["bound_ms"] = b * (rows * every + live * live_only) / HBM_BYTES_PER_S * 1e3
            out[f"{kernel}@{name}"] = row
        del sc, grads, leaves, proj, loss
        torch.cuda.empty_cache()
    return out


def rising_errors(fa, bh: int, n: int, seed: int) -> Dict[str, float]:
    """Largest |K5 - plain twin|, |K5 - float64| and |plain twin - float64|
    at f32 inputs with keys in rising norm (``k5_inputs(..., rising=True)``);
    float64 is the plain twin's function evaluated in float64, here rather
    than by ``profiling.k5_float64``, which an older timed tree lacks."""
    from threestudio_3dgs_tpu_torch.utils.profiling import k5_inputs

    q, k, v = k5_inputs(bh, n, torch.float32, seed=seed, rising=True)
    got, plain = fa.flash_bhnd_cuda(q, k, v, 0.125).double(), fa.flash_bhnd_torch(q, k, v, 0.125)
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * 0.125
    exact = torch.softmax(s, dim=-1) @ v.double()
    return {"kernel_plain": float((got - plain).abs().max()),
            "kernel_f64": float((got - exact).abs().max()),
            "plain_f64": float((plain - exact).abs().max())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--run-dir", default=os.path.join("outputs", "kernel_timing"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel timing needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from threestudio_3dgs_tpu_torch.ops.rasterizer import expand
    from threestudio_3dgs_tpu_torch.utils.profiling import bench_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    result = {"package": os.path.dirname(port.__file__), "inputs": {}}
    for name, make in (("train", lambda: train_view_scene(args.run_dir)),
                       ("bench", lambda: bench_scene("cuda"))):
        inp = view_inputs(make(), seed=2)
        row = {"pairs": int(inp["pair_feats"].shape[0]),
               "live_slots": int((inp["plan"].kept > 0).sum())}
        with torch.no_grad():
            for kernel, (call, library) in kernel_calls(inp).items():
                row[kernel] = time_call(call, args.iters)
                if library is not None:
                    row[kernel].update(time_call(library, args.iters, "library_"))
            if name == "bench":
                plan = inp["plan"]
                offsets, max_pairs = plan.offsets.int().contiguous(), -(-plan.n_pairs // 512) * 512
                positions = torch.arange(max_pairs, dtype=torch.int32, device="cuda")
                row["expand_slots"] = time_call(
                    lambda: expand.expand_slots_cuda(offsets, max_pairs), args.iters)
                row["expand_slots"].update(time_call(
                    lambda: torch.searchsorted(offsets, positions, right=True) - 1, args.iters,
                    "library_"))
        result["inputs"][name] = row
        del inp
        torch.cuda.empty_cache()
    for tag, row in project_rows(args.iters).items():
        kernel, shape = tag.split("@")
        result["inputs"].setdefault(f"k7_{shape}", {})[kernel] = row
    # K5 at the UNet's two self-attention shapes, beside SDPA
    import torch.nn.functional as F

    from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
    from threestudio_3dgs_tpu_torch.utils.profiling import k5_inputs

    bf16, f32 = torch.bfloat16, torch.float32
    for bh, n, d, dtype in ((40, 4096, 64, bf16), (80, 1024, 64, bf16), (10, 4096, 64, f32),
                            (20, 1024, 64, f32), (64, 1024, 40, bf16), (320, 1024, 40, bf16),
                            (64, 1024, 80, bf16), (64, 1024, 160, bf16)):
        tag = f"k5_{bh}x{n}x{d}" + ("" if dtype == bf16 else ":f32")
        try:
            fa.k5_kernel(dtype, bh, n, d, d**-0.5)
        except ValueError as e:
            print(f"{tag}: not taken by this tree's K5 ({e})", flush=True)
            continue
        q, k, v = k5_inputs(bh, n, dtype, seed=20, d=d)
        with torch.no_grad():
            row = time_call(lambda: fa.flash_bhnd_cuda(q, k, v, d**-0.5), args.iters)
            row.update(time_call(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=d**-0.5), args.iters, "library_"))
            if dtype == f32:
                row["rising_errors_by_seed"] = [rising_errors(fa, bh, n, seed) for seed in range(8)]
        result["inputs"][tag] = {"flash_attention_forward": row}
        del q, k, v
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
