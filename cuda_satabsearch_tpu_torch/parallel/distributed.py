"""Multi-process runs: process group, rank, and the all-gather of results.

Counterpart of cuda_satabsearch_tpu/parallel/distributed.py.  One
process per GPU, as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``): each rank searches the shards of the mesh on its own
``LOCAL_RANK`` device (parallel/mesh.py), and ``to_host`` all-gathers
each shard's scores and maps so that every rank holds the whole
file-order result, as the JAX package's ``process_allgather`` does.
The process group uses NCCL on CUDA devices and gloo on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def local_device() -> torch.device:
    """The device this process searches on: CUDA device ``LOCAL_RANK``
    when a card is present, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device: torch.device | str | None = None) -> None:
    """``torch.distributed.init_process_group`` for this process (NCCL
    when ``device``, default ``local_device()``, is a CUDA device, gloo on
    the CPU).  Arguments left out come from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``).  A no-op at world
    size 1."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if world_size == 1 or dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dev = torch.device(device) if device is not None else local_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that should print results (rank 0)."""
    return rank() == 0


def to_host(x: torch.Tensor, dim: int = 0) -> np.ndarray:
    """``x`` on the host.  In a multi-process run, every rank's ``x``
    (one shard's rows along ``dim``; the same shape on every rank)
    concatenated along ``dim`` in rank order, on every rank."""
    if world_size() > 1:
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x.contiguous())
        x = torch.cat(parts, dim=dim)
    return x.cpu().numpy()
