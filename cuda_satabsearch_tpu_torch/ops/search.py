"""High-level search: backend choice, DB upload, whole-DB search.

Counterpart of cuda_satabsearch_tpu/ops/search.py.  The DB is uploaded
once per session (``upload_db``, the analog of the reference's one-time
cudaMemcpy3D of the whole DB, cudaSaTabsearch.cu:924-963), whole or as
entry shards over a mesh of devices, each shard with its launch plan;
each search runs at most two launches per shard (ops/kernel_search.py)
and returns results in database file order.  RNG keys derive from
(seed, query tag, the entry's file-order index), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.constants import DEFAULT_MAXSTART, DEFAULTS, SAParams
from ..parallel.mesh import mesh_shards, shard_rows
from .common import C_MAX
from .kernel_search import (Launched, Plan, drain, launch_group, make_plan,
                            prepare_bucket)

DEFAULT_SEED = 1234  # the reference's fixed seed (cudaSaTabsearch.cu:263,:871)


@dataclass
class SearchResult:
    scores: np.ndarray  # int32 [nentries], database file order
    ssemaps: np.ndarray | None  # int32 [nentries, n1], -1 where unmapped
    names: list[str]
    orders: np.ndarray  # int32 [nentries]
    query_order: int
    maxstart: int

    @property
    def nentries(self) -> int:
        return len(self.names)


def choose_chains(maxstart: int, c_max: int = C_MAX) -> tuple[int, int]:
    """Split total restarts into (parallel chains, sequential restarts):
    the largest divisor of ``maxstart`` that is <= c_max runs as
    parallel chains (one CUDA thread each), the rest as restarts in
    order (the reference requires maxstart to be a multiple of its
    128-thread block for the same reason, cudaSaTabsearch.cu:34-35)."""
    if maxstart < 1:
        raise ValueError("maxstart must be >= 1")
    for c in range(min(maxstart, c_max), 0, -1):
        if maxstart % c == 0:
            return c, maxstart // c
    return 1, maxstart


def resolve_backend(backend: str = "auto", device=None
                    ) -> tuple[str, torch.device]:
    """(backend, device) for a search.

    "cuda" runs the CUDA kernel and "torch" the plain PyTorch engine.
    "auto" is "cuda" when a card is present.  Without a card only an
    explicit CPU device (the ``-c`` path) runs, on the plain engine;
    nothing moves to the CPU on its own."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if device is not None and torch.device(device).type == "cpu":
        if backend == "cuda":
            raise ValueError("the CUDA kernel needs a CUDA device")
        return "torch", torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; run with -c for the plain "
                           "engine on the CPU")
    dev = torch.device(device if device is not None else "cuda")
    return ("cuda" if backend == "auto" else backend), dev


def upload_db(db, devices) -> list[Plan]:
    """Upload a PackedDB (from either package's packer) once, as shards,
    and make each shard's launch plan.  ``devices`` is one device (one
    shard: the whole DB) or a mesh (parallel/mesh.make_mesh): shard
    first + i of the run's shards goes to ``devices[i]`` and holds rows
    ``shard_rows`` of every bucket."""
    if not isinstance(devices, (list, tuple)):
        dev = torch.device(devices)
        return [make_plan([prepare_bucket(b, dev) for b in db.buckets], dev)]
    first, total = mesh_shards(devices)
    return [make_plan([prepare_bucket(b, dev, shard_rows(b.size, total,
                                                         first + i))
                       for b in db.buckets], dev)
            for i, dev in enumerate(devices)]


def launch_db_many(queries, shards: list[Plan], *,
                   maxstart: int = DEFAULT_MAXSTART, lorder: bool = True,
                   lsoln: bool = True, seed: int = DEFAULT_SEED,
                   query_tags, c_max: int = C_MAX, backend: str = "cuda",
                   params: SAParams = DEFAULTS) -> Launched:
    """Launch queries that share round8(order) on every shard
    (``shards`` from upload_db): at most two launches per shard and
    query tile (ops/kernel_search.launch_group); ``drain_db_many``
    brings the results back."""
    c_par, r_seq = choose_chains(maxstart, min(c_max, C_MAX))
    return launch_group(queries, shards, lorder=lorder, lsoln=lsoln,
                        seed=seed, query_tags=query_tags, c_par=c_par,
                        r_seq=r_seq, backend=backend, params=params)


def drain_db_many(launched: list[Launched], db, *, maxstart: int,
                  gather: bool = False) -> list[list[SearchResult]]:
    """The results of launched groups, per group in query order, in one
    drain (``gather``: all-gather the shards of a multi-process run)."""
    return [[SearchResult(scores=s, ssemaps=m, names=db.names,
                          orders=db.orders, query_order=q.order,
                          maxstart=maxstart)
             for q, (s, m) in zip(group.queries, outs)]
            for group, outs in zip(launched,
                                   drain(launched, db.nentries, gather))]


def search_db_many(queries, db, shards: list[Plan], *,
                   maxstart: int = DEFAULT_MAXSTART, gather: bool = False,
                   **kw) -> list[SearchResult]:
    """Search queries that share round8(order): ``launch_db_many``'s
    keywords, then their drain."""
    launched = launch_db_many(queries, shards, maxstart=maxstart, **kw)
    return drain_db_many([launched], db, maxstart=maxstart,
                         gather=gather)[0]


def search_db(query, db, shards: list[Plan], *,
              query_tag: int = 0, **kw) -> SearchResult:
    """Search the whole packed DB for one query; results in database
    file order."""
    return search_db_many([query], db, shards, query_tags=[query_tag],
                          **kw)[0]
