"""Rank processes of the port's multi-device CPU tests
(tests/test_torch_parallel.py, tests/test_torch_hybrid_parallel.py).

``spawn_ranks`` starts ``world`` gloo ranks with ``torch.multiprocessing``'s
spawn method (never fork: the pytest process holds JAX's threads),
rendezvousing through a file under the test's tmp directory (no fixed
port: test files run side by side).  Each rank runs every case of the list
in order, a case being (name, function name in this module, kwargs), and
pickles {name: result} to ``rank<r>.pkl``; the parent reads one dict a rank.
Results are numpy arrays and plain numbers.  This module imports torch and
the port only: a rank process imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

Case = Tuple[str, str, Dict[str, Any]]


def spawn_ranks(world: int, cases: Sequence[Case], tmp_dir: str) -> List[Dict[str, Any]]:
    os.makedirs(tmp_dir, exist_ok=True)
    init_file = os.path.join(tmp_dir, "rendezvous")
    mp.start_processes(_rank_main, args=(world, init_file, list(cases), tmp_dir), nprocs=world,
                       join=True, start_method="spawn")
    results = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(rank: int, world: int, init_file: str, cases: List[Case], out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    results = {}
    try:
        for name, fn, kwargs in cases:
            results[name] = globals()[fn](**kwargs)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_arrays(gauss) -> Dict[str, np.ndarray]:
    """The field's params and densify statistics, by name."""
    from threestudio_3dgs_tpu_torch.models.gaussian_field import STAT_FIELDS

    out = {k: host(v) for k, v in gauss.params.as_dict().items()}
    out.update({k: host(getattr(gauss, k)) for k in STAT_FIELDS})
    return out


def state_digest(gauss) -> str:
    """One hash of every params, Adam moment and statistics byte."""
    h = hashlib.sha256()
    arrays = state_arrays(gauss)
    arrays.update({f"mu/{k}": host(v) for k, v in gauss.adam.mu.items()})
    arrays.update({f"nu/{k}": host(v) for k, v in gauss.adam.nu.items()})
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def host_logs(logs) -> Dict[str, float]:
    return {k: float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
            for k, v in logs.items()}


def scene_tensors(scene: Sequence[np.ndarray], requires_grad=False) -> List[torch.Tensor]:
    return [torch.tensor(a, requires_grad=requires_grad) for a in scene]


def camera(c2w: np.ndarray, fov: float, height: int, width: int):
    from threestudio_3dgs_tpu_torch.ops import camera as cam_ops

    return cam_ops.camera_from_c2w(c2w, fov, fov, height, width, device="cpu")


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def dp_step(system_cfg: dict, ckpt: str, batch: dict, chunks: int = 4, repeats: int = 1,
            seed: int = 0) -> Dict[str, Any]:
    """``make_dp_train_step`` over the world on this rank's shard of
    ``batch`` from the checkpoint's state (loaded anew for each repeat: the
    step updates in place).  Returns each repeat's field, logs and the
    renderer's path counts."""
    from threestudio_3dgs_tpu_torch.parallel.data_parallel import make_dp_train_step, shard_batch
    from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
    from threestudio_3dgs_tpu_torch.utils.registry import find

    world, rank = dist.get_world_size(), dist.get_rank()
    bs = len(batch["c2w"])
    runs = []
    for _ in range(repeats):
        system = find("gaussian-splatting-system")(system_cfg, device="cpu")
        state, _ = load_checkpoint(ckpt, "cpu")
        step = make_dp_train_step(system, dist.group.WORLD, bs, chunks=chunks)
        new, logs = step(state, shard_batch(batch, rank, world, bs), 0,
                         torch.Generator().manual_seed(seed))
        runs.append(dict(state=state_arrays(new.gauss), logs=host_logs(logs),
                         paths=dict(system.renderer.path_counts)))
    return dict(runs=runs)


def one_process_step(system_cfg: dict, ckpt: str, batch: dict, seed: int = 0):
    """The system's one-process train step on the whole batch (no mesh)."""
    from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint
    from threestudio_3dgs_tpu_torch.utils.registry import find

    system = find("gaussian-splatting-system")(system_cfg, device="cpu")
    state, _ = load_checkpoint(ckpt, "cpu")
    new, logs = system.train_step(state, batch, 0, torch.Generator().manual_seed(seed))
    return dict(state=state_arrays(new.gauss), logs=host_logs(logs))


def tile_render(scene: Sequence[np.ndarray], c2w: np.ndarray, fov: float, size: int, bg,
                tile_size: int, max_pairs: int, grads: bool = False) -> Dict[str, Any]:
    """``make_tile_parallel_rasterize`` over the world: this rank's band,
    the gathered view and the full radii / unioned visibility / counts;
    with ``grads`` the inputs' gradients of sum(image^2) + 0.2 sum(alpha)
    over the bands (the full render's loss)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig
    from threestudio_3dgs_tpu_torch.parallel.tile_parallel import (
        gather_bands, make_tile_parallel_rasterize)

    cam = camera(c2w, fov, size, size)
    cfg = RasterizeConfig(tile_size=tile_size, max_pairs=max_pairs)
    f = make_tile_parallel_rasterize(dist.group.WORLD, cam, torch.tensor(bg), config=cfg)
    xs = scene_tensors(scene, requires_grad=grads)
    out = f(*xs)
    res = {k: host(v) for k, v in gather_bands(out, dist.group.WORLD).items()}
    res.update(band_image=host(out["image"]), radii=host(out["radii"]),
               visibility=host(out["visibility"]), n_pairs=out["n_pairs"],
               n_dropped=out["n_dropped"])
    if grads:
        loss = torch.sum(out["image"] ** 2) + 0.2 * torch.sum(out["alpha"])
        res["grads"] = [host(g) for g in torch.autograd.grad(loss, xs)]
    return res


def hybrid_render(scene: Sequence[np.ndarray], c2ws: Sequence[np.ndarray], fov: float,
                  size: int, bg, tile_size: int, max_pairs: int, shape=(2, 2)) -> Dict[str, Any]:
    """``make_hybrid_rasterize`` on a (data, tile) mesh of the world: the
    gathered batch, this rank's radii / visibility / counts, and the inputs'
    gradients of sum(image^2) + sum(alpha) over the mesh."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig
    from threestudio_3dgs_tpu_torch.parallel.hybrid import gather_views, make_hybrid_rasterize
    from threestudio_3dgs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "tile"), device_type="cpu")
    cams = [camera(c, fov, size, size) for c in c2ws]
    cfg = RasterizeConfig(tile_size=tile_size, max_pairs=max_pairs)
    f = make_hybrid_rasterize(mesh, cams, torch.tensor(bg), config=cfg)
    xs = scene_tensors(scene, requires_grad=True)
    out = f(*xs)
    res = {k: host(v) for k, v in gather_views(out, mesh).items()}
    res.update(coordinate=list(mesh.get_coordinate()), radii=host(out["radii"]),
               visibility=host(out["visibility"]), n_pairs=out["n_pairs"],
               n_dropped=out["n_dropped"])
    loss = torch.sum(out["image"] ** 2) + torch.sum(out["alpha"])
    res["grads"] = [host(g) for g in torch.autograd.grad(loss, xs)]
    return res


def chunked_vs_plain(trees: Dict[str, Dict[str, np.ndarray]], chunks: int = 4):
    """``chunked_pmean`` and one all_reduce SUM / world a leaf over this
    rank's leaves (each rank's tree offset by its rank)."""
    from threestudio_3dgs_tpu_torch.parallel.data_parallel import chunked_pmean

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, tree in trees.items():
        mine = {k: torch.tensor(v) * (rank + 1) for k, v in tree.items()}
        chunked = chunked_pmean({k: v.clone() for k, v in mine.items()}, dist.group.WORLD,
                                chunks=chunks)
        plain = {}
        for k, v in mine.items():
            v = v.clone()
            dist.all_reduce(v)
            plain[k] = v / world
        out[name] = dict(chunked={k: host(v) for k, v in chunked.items()},
                         plain={k: host(v) for k, v in plain.items()})
    return out


def train(config: str, overrides: Sequence[str]) -> Dict[str, Any]:
    """``Trainer.fit`` of the YAML on the CPU in this rank: the mesh, the
    dp steps it cached, its logs, the state's digest and the lines of
    ``metrics.jsonl`` in its run directory (the ranks' directories coincide
    when their timestamps do)."""
    from threestudio_3dgs_tpu_torch.trainer import Trainer
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    cfg = load_config(config, list(overrides))
    tr = Trainer(cfg, device="cpu")
    tr.fit()
    res = dict(
        mesh_size=None if tr.mesh is None else tr.mesh.size(),
        system_mesh_is_trainer_mesh=tr.system.mesh is tr.mesh,
        dp_steps=sorted(tr.system._dp_steps),
        metrics=[dict(row) for row in tr.metrics_log],
        digest=state_digest(tr.state.gauss),
        save_dir=tr.save_dir,
    )
    dist.barrier()
    metrics = os.path.join(tr.save_dir, "metrics.jsonl")
    if os.path.exists(metrics):
        with open(metrics) as f:
            res["metrics_lines"] = len(f.readlines())
    tr.close()
    return res
