"""Camera-sharded data-parallel training step on ``torch.distributed`` (port
of the JAX package's ``parallel/data_parallel.py``).

The JAX package runs the step inside ``shard_map`` on one process's mesh;
the port runs one process per rank.  What JAX does on a replicated state
and key, every rank does with the same seed: it holds the whole state,
draws the same full camera batch and keeps its rows (``shard_batch``), and
its step generator is seeded alike, so the draws of its equally shaped
shard are the other ranks' draws.  A step renders the rank's shard, takes
the gradients of its local loss and averages them over the ranks
(``chunked_pmean``); the densify statistics reduce by max (radii) and sum
(visibility, means2d gradient norms), the pair counts by sum (drops) and
max (per-view demand), so every rank's capacity controller adapts alike.
Adam, the statistics, the controller and the structural update then run
identically on every rank, and the replicated state stays bit-identical
without further communication.

As in the JAX package, each rank's means2d side channel takes the gradient
of its LOCAL mean loss, so the means2d statistics grow with the number of
ranks (``data_parallel.py:125-138`` of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..models import gaussian_field as gf

# chunks per large gradient leaf in chunked_pmean (1: one collective a leaf)
GRAD_PSUM_CHUNKS = 4
# leaves below this many elements go through one collective
CHUNK_MIN_NUMEL = 64 * 1024


def chunked_pmean(tensors: Dict[str, torch.Tensor], group=None, chunks: int = GRAD_PSUM_CHUNKS,
                  n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The mean over the group's ranks of each tensor, in place: all_reduce
    SUM (gloo has no AVG) then a division by ``n`` (the group's size, or the
    number of ranks whose terms are not zeros).  A tensor of at least
    CHUNK_MIN_NUMEL elements and ``chunks`` rows is reduced in ``chunks``
    row chunks, each element once, so the collectives of one leaf pipeline;
    every collective is issued asynchronously and all are waited before the
    division.  Returns the (contiguous) tensors by key."""
    n = dist.get_world_size(group) if n is None else n
    out = {k: x.contiguous() for k, x in tensors.items()}
    work = []
    for x in out.values():
        rows = x.shape[0] if x.dim() else 0
        if chunks <= 1 or rows < chunks or x.numel() < CHUNK_MIN_NUMEL:
            parts = [x]
        else:
            bounds = [rows * i // chunks for i in range(chunks + 1)]
            parts = [x[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        for part in parts:
            work.append(dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group, async_op=True))
    for w in work:
        w.wait()
    for x in out.values():
        x.div_(n)
    return out


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


def make_dp_train_step(system, group, global_batch: int, n_shards: Optional[int] = None,
                       chunks: int = GRAD_PSUM_CHUNKS):
    """A data-parallel train step for a ``BaseGaussianSystem`` over
    ``group``: step(state, batch_shard, step, generator) -> (state, logs),
    ``batch_shard`` this rank's rows of the global camera batch
    (``shard_batch``).  The first ``n_shards`` ranks (default: all) hold a
    shard each, and global_batch % n_shards == 0; a rank past them (a
    camera batch the group's size does not divide) steps a copy of rank
    ``rank % n_shards``'s shard, so its draws and log keys are that rank's,
    and contributes zeros to every reduction, whose means divide by
    ``n_shards``: the JAX package's pmean over its gcd sub-mesh."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_shards = world if n_shards is None else n_shards
    assert global_batch % n_shards == 0 and 0 < n_shards <= world, (global_batch, n_shards, world)
    active = rank < n_shards
    device = system.device
    SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX

    def step(state, batch_shard: Dict[str, Any], step_idx: int, generator: torch.Generator):
        sched = system.sched_scalars(step_idx)
        capacity = system._pair_capacity()
        system.renderer.max_pairs_override = capacity
        g_gauss, g_extra, outs, vs_grad_norm, logs = system.local_gradients(
            state, batch_shard, step_idx, sched, generator)
        radii_max, grad_sum, vis_count = gf.view_stats(
            outs[-1]["radii"].float(), outs[-1]["visibility_filter"], vs_grad_norm)
        log_keys = [k for k, v in logs.items() if isinstance(v, torch.Tensor)]
        log_vec = torch.stack([logs[k].detach().float().to(device).reshape(()) for k in log_keys])
        counts = torch.tensor([logs["n_dropped_pairs"], logs["n_pairs_max"]], dtype=torch.int64,
                              device=device)
        stat_sums = torch.stack([grad_sum, vis_count])
        if not active:
            for x in (*g_gauss.values(), *g_extra.values(), radii_max, stat_sums, log_vec, counts):
                x.zero_()

        # the gradient all-reduce: per-shard means average to the global
        # batch's mean; batch-independent regularisers are equal on every
        # rank (the mean is the identity there)
        g_gauss = chunked_pmean(g_gauss, group, chunks, n_shards)
        g_extra = chunked_pmean(g_extra, group, 1, n_shards)
        log_vec = chunked_pmean({"logs": log_vec}, group, 1, n_shards)["logs"]
        logs = dict(logs, **{k: log_vec[i] for i, k in enumerate(log_keys)})
        # the densify statistics and the capacity signals over the whole batch
        radii_max = _reduce(radii_max, MAX, group)
        grad_sum, vis_count = _reduce(stat_sums, SUM, group)
        dropped = _reduce(counts[:1].clone(), SUM, group)
        demand = _reduce(counts[1:].clone(), MAX, group)
        logs["n_dropped_pairs"] = int(dropped)
        logs["n_pairs_max"] = int(demand)
        return system.finish_step(
            state, g_gauss, g_extra, logs, step_idx, sched, generator, capacity,
            add_stats=lambda gauss: system.geometry.add_stats(gauss, radii_max, grad_sum,
                                                              vis_count))

    return step


def shard_batch(batch: Dict[str, Any], rank: int, world: int,
                batch_size: Optional[int] = None) -> Dict[str, Any]:
    """Rank ``rank``'s rows of a camera batch split into ``world`` equal
    shards.  An entry is sliced only when its leading dim equals the global
    camera batch (``batch_size``, else the ``c2w`` row count): mere
    divisibility would mis-shard an aux table whose first dim happens to
    divide the world size, which must replicate instead."""
    if batch_size is None and "c2w" in batch and hasattr(batch["c2w"], "shape"):
        batch_size = int(batch["c2w"].shape[0])
    out = {}
    for k, v in batch.items():
        shape = getattr(v, "shape", None)
        is_batched = (
            shape is not None and len(shape) >= 1 and shape[0] > 0 and shape[0] % world == 0
            and (batch_size is None or shape[0] == batch_size)
        )
        if is_batched:
            per = shape[0] // world
            out[k] = v[rank * per:(rank + 1) * per]
        else:
            out[k] = v
    return out
