"""Monotone segmented sum: the CUDA kernel K3 and its plain torch twin.

Port of the JAX package's ``ops/rasterizer/segsum_pallas.py``
(``segsum_monotone_pallas``, replaced here by ``csrc/segsum.cu``): the
per-Gaussian sum of gradient rows that arrive sorted by Gaussian id, each
Gaussian owning the contiguous rows [offsets[i], offsets[i] + counts[i]).
``segsum_monotone`` takes the plain twin for CPU tensors and launches the
kernel for CUDA tensors (counted under ``native.SHAPE_LAUNCHES[(fn, tag)]``
where the caller gives a tag: "stacked" for the batched render's B * N
segments).
"""

from __future__ import annotations

import torch

from .. import native

MAX_COLUMNS = 1024  # a K3 block holds its (segment, column) sums on chip (csrc/segsum.cu kItems)


def segsum_torch(vals: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor):
    """Plain twin: ``index_add_`` of every row into its segment.  Rows past
    the last segment's end are not read."""
    n = counts.shape[0]
    seg = torch.repeat_interleave(torch.arange(n, device=vals.device), counts)
    start = int(offsets[0]) if n else 0
    rows = vals[start : start + seg.shape[0]]
    out = torch.zeros((n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, rows)


def segsum_cuda(vals: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor, tag: str = ""):
    """K3 on the card: a block per run of consecutive segments streams their
    rows through shared memory; one thread per (segment, column) sums them
    in row order, no atomics."""
    native.check_cuda_tensor(vals, "vals", torch.float32, 2)
    native.check_cuda_tensor(offsets, "offsets", torch.int64, 1)
    native.check_cuda_tensor(counts, "counts", torch.int64, 1)
    if offsets.shape != counts.shape:
        raise ValueError("offsets and counts must have the same shape")
    n, f = counts.shape[0], vals.shape[1]
    if f > MAX_COLUMNS:
        raise ValueError(f"K3 takes at most {MAX_COLUMNS} columns, got {f}")
    out = torch.empty((n, f), dtype=torch.float32, device=vals.device)
    native.launch(
        "segsum_monotone", vals.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
        out.data_ptr(), n, f, vals.shape[0], native.stream_handle(vals.device), shape=tag,
    )
    return out


def segsum_monotone(vals: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
                    tag: str = ""):
    """(P, F) rows sorted by segment -> (N, F) per-segment sums.  Segments
    must be contiguous and in order: offsets[i+1] = offsets[i] + counts[i]."""
    if vals.device.type == "cpu":
        return segsum_torch(vals, offsets, counts)
    return segsum_cuda(vals, offsets, counts, tag)
