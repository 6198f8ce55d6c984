"""Process groups and device meshes (port of the JAX package's
``parallel/mesh.py``).

The JAX package drives every device from one process through a
``jax.sharding.Mesh``; the port runs one process per rank, as ``torchrun``
starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` in the environment), and names the ranks' layout with a
``torch.distributed.device_mesh.DeviceMesh``: a 1-D ``("data",)`` mesh over
cameras for training, a 2-D ``("data", "tile")`` one for the hybrid renderer.
The backend is always the caller's choice: NCCL for one rank a card, gloo
for the CPU (and for ranks that share a card, which NCCL refuses)."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def initialize_distributed(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    force: bool = False,
) -> bool:
    """Initialise the default process group; returns whether this call did
    (the caller then owns it and destroys it).  ``world_size`` and ``rank``
    default to ``torchrun``'s ``WORLD_SIZE`` / ``RANK`` (1 / 0 without them),
    ``init_method`` to ``env://`` where ``MASTER_ADDR`` is set.  A no-op when
    a group exists, and at world size 1 unless ``force``: a one-rank group
    then lives in an in-process store."""
    if dist.is_initialized():
        return False
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if world_size <= 1 and not force:
        return False
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"world size {world_size} needs an init_method (or torchrun's env)")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    return True


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the default group's ranks, row-major: (world,) by
    default; shape (n_data, n_tile) with axis_names ("data", "tile") for
    the hybrid renderer."""
    if shape is None:
        shape = (dist.get_world_size(),)
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))
