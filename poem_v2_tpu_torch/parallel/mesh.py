"""The data half of ``poem_v2_tpu/parallel/mesh.py`` over ``torch.distributed``.

The JAX package shards a global batch over the ``data`` axis of one SPMD
program. Here each rank is a process (``torchrun --nproc_per_node N``, one
per card) that keeps rows ``rank * local:(rank + 1) * local`` of the global
batch, the rows ``P("data")`` places on device ``rank``, and
``DistributedDataParallel`` averages the gradients. The tensor-parallel half
(``infer_param_shardings``, ``shard_params``) is not ported: the widest tier
trains on one card.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def in_group() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group; 1 outside one."""
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 outside one."""
    return dist.get_rank() if in_group() else 0


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def launched_world_size() -> int:
    """The default process group's size, or before it forms the world size
    torchrun launched this process into (``WORLD_SIZE``); 1 without either."""
    return world_size() if in_group() else int(os.environ.get("WORLD_SIZE", 1))


def init_distributed(device_type: str) -> Tuple[int, int]:
    """Join the process group torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; across hosts too), over
    NCCL for ``device_type`` ``"cuda"`` and gloo for ``"cpu"``. A group that
    already exists is kept; without torchrun's environment the process runs
    alone. Returns (rank, world size)."""
    if not in_group() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return rank(), world_size()


def local_batch_size(global_batch: int, world: int) -> int:
    """Rows of the global batch on each rank; raises unless they divide evenly."""
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not divide over {world} ranks")
    return global_batch // world


def shard_batch(batch: Mapping[str, T], rank: int, world: int) -> Dict[str, T]:
    """Rank ``rank``'s rows of every array of a global batch (leading axis)."""
    n = local_batch_size(len(next(iter(batch.values()))), world)
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the default process group (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t)
    return t
