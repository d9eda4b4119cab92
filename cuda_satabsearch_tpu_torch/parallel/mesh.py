"""Sharding of the database entry axis over devices.

Counterpart of cuda_satabsearch_tpu/parallel/mesh.py.  The SA search is
independent per DB entry, and every entry's random stream is keyed by
its file-order index (ops/rng.entry_keys), so any split of the entries
gives the same bits.  A mesh is a list of torch devices; the DB is
packed with ``pad_to`` = the number of shards in the run, and shard s
holds rows [s*n/S, (s+1)*n/S) of every bucket: the contiguous split of
the JAX package's ``NamedSharding(mesh, P("entries"))`` (:40-42).  In a
multi-process run (parallel/distributed.py) the mesh of each process
holds its own devices, and its shards follow those of the lower ranks.
"""

from __future__ import annotations

import torch

from . import distributed


def make_mesh(devices=None) -> list[torch.device]:
    """The devices of this process's shards, shard i on ``devices[i]``.
    Default: every visible CUDA device, or in a multi-process run this
    process's ``LOCAL_RANK`` device.  A list may repeat a device (two
    shards on one card)."""
    if devices is None:
        if distributed.world_size() > 1:
            devices = [distributed.local_device()]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device found; run with -c for the "
                               "plain engine on the CPU")
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {mesh}")
    return mesh


def mesh_shards(mesh: list[torch.device]) -> tuple[int, int]:
    """(number of this process's first shard, shards in the whole run)."""
    return distributed.rank() * len(mesh), distributed.world_size() * len(mesh)


def shard_rows(n: int, nshards: int, shard: int) -> slice:
    """Rows of shard ``shard`` of ``nshards`` in a bucket of ``n`` rows
    (n a multiple of nshards: the DB was packed with pad_to=nshards)."""
    if n % nshards:
        raise ValueError(f"{n} bucket rows do not split into {nshards} "
                         f"shards: pack the DB with pad_to={nshards}")
    per = n // nshards
    return slice(shard * per, (shard + 1) * per)
