"""High-level search: backend choice, DB upload, whole-DB search.

Counterpart of cuda_satabsearch_tpu/ops/search.py.  The DB is uploaded
once per session (``upload_db``, the analog of the reference's one-time
cudaMemcpy3D of the whole DB, cudaSaTabsearch.cu:924-963), whole or as
entry shards over a mesh of devices, each shard with its launch plan.
A ``Searcher`` searches it: a round8 group of queries is staged once
and launched on every shard (ops/kernel_search.Step: at most two
launches per shard and query tile), and any number of launched groups
are drained at once, with results in database file order.  On one
card, a one-query search replays a CUDA graph of its step.  RNG keys
derive from (seed, query tag, the entry's file-order index), as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..core.constants import DEFAULT_MAXSTART, DEFAULTS
from ..parallel.mesh import mesh_shards, shard_rows
from .common import C_MAX, round8
from .kernel_search import (Plan, Staging, Step, capture_graph, make_plan,
                            prepare_bucket, stage)

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


def uses_graphs(backend: str, mesh) -> bool:
    """Whether one-query searches replay CUDA graphs: the kernel's backend
    on one card, with no mesh (one shard, nothing gathered across
    processes)."""
    return backend == "cuda" and mesh is None


def upload_db(db, devices) -> list[Plan]:
    """Upload a PackedDB (from either package's packer) once, as shards,
    and make each shard's launch plan.  ``devices`` is one device (one
    shard: the whole DB) or a mesh (parallel/mesh.make_mesh): shard
    first + i of the run's shards goes to ``devices[i]`` and holds rows
    ``shard_rows`` of every bucket.  A run of one shard in all makes the
    whole DB's plan (ops/kernel_search.make_plan's ``nentries``)."""
    if not isinstance(devices, (list, tuple)):
        dev = torch.device(devices)
        return [make_plan([prepare_bucket(b, dev) for b in db.buckets], dev,
                          db.nentries)]
    first, total = mesh_shards(devices)
    whole = db.nentries if total == 1 else None
    return [make_plan([prepare_bucket(b, dev, shard_rows(b.size, total,
                                                         first + i))
                       for b in db.buckets], dev, whole)
            for i, dev in enumerate(devices)]


@dataclass
class Launched:
    """A round8 group launched on every shard and not drained yet."""

    queries: list
    n1r: int
    lsoln: bool
    staging: Staging  # the queries and tags (ops/kernel_search.stage)
    steps: list  # an ops/kernel_search.Step per shard with entries


class Searcher:
    """Searches of a packed DB uploaded as shards (``upload_db``; ``gather``:
    across the processes of a multi-process run) under one session's
    settings, ``choose_chains`` taken once: ``launch`` and ``drain`` run
    a stream of round8 groups, ``search`` one query.

    ``graphs`` (``uses_graphs``): a key's (round8 order, LORDER, LSOLN)
    first two one-query searches run eagerly, so that a fresh process's
    first search pays no capture; the second captures the step it
    drained (ops/kernel_search.Step.capture), and every later one stages
    into that group and replays it.  Lists run eagerly.  ``capture``
    makes the replay (ops/kernel_search.capture_graph; None: no graphs)."""

    def __init__(self, db, shards: list[Plan], *,
                 maxstart: int = DEFAULT_MAXSTART, c_max: int = C_MAX,
                 seed: int = DEFAULT_SEED, params=DEFAULTS,
                 backend: str = "cuda", gather: bool = False,
                 graphs: bool = False):
        self.db, self.shards = db, shards
        self.maxstart, self.gather = maxstart, gather
        c_par, r_seq = choose_chains(maxstart, min(c_max, C_MAX))
        self.kw = dict(backend=backend, seed=seed, c_par=c_par, r_seq=r_seq,
                       params=params)
        self.pin = any(p.device.type == "cuda" for p in shards)
        self.capture = capture_graph if graphs else None
        self.seen: set = set()  # keys searched eagerly
        self.graphs: dict = {}  # key -> the captured group it replays

    def launch(self, queries, tags, *, lorder: bool, lsoln: bool,
               group: Launched | None = None) -> Launched:
        """Launch K queries of one round8 group under their tags on every
        shard, without waiting: stage them once (pinned on a card) and run
        each shard's step; or restage ``group``, a captured one-query
        group of the same key, and replay it."""
        sp = trace.begin("kernel_search.launch_group", tags[0], len(queries))
        try:
            if group is None:
                K, n1r = len(queries), round8(max(q.order for q in queries))
                if any(round8(q.order) != n1r for q in queries):
                    raise ValueError("queries of one call must share "
                                     "round8(order)")
                group = Launched(list(queries), n1r, lsoln,
                                 Staging(K, n1r, self.pin),
                                 [Step(p, K, n1r, lorder=lorder, lsoln=lsoln,
                                       gather=self.gather, **self.kw)
                                  for p in self.shards if p.nentries])
            group.queries = list(queries)
            stage(group.staging, queries, tags)
            for step in group.steps:
                step.run(group.staging.buf, tags)
            return group
        finally:
            trace.end(sp)

    def drain(self, launched: list[Launched]) -> list[list[SearchResult]]:
        """The results of launched groups, per group in query order, entries
        in database file order, each query's in arrays of its own: the
        stream's only wait for the device.  The bytes brought to the host
        are recorded on the ``kernel_search.drain`` span (trace.py)."""
        sp = trace.begin("kernel_search.drain")
        nbytes = 0
        try:
            arrays = []
            for g in launched:
                blocks = [step.results() for step in g.steps]
                nbytes += sum(s.nbytes + (0 if m is None else m.nbytes)
                              for _, s, m in blocks)
                if len(blocks) == 1 and g.steps[0].plan.whole:
                    _, scores, maps = blocks[0]
                else:  # a mesh's blocks, at their entries' file positions
                    K, E = len(g.queries), self.db.nentries
                    scores = np.zeros((K, E), np.int32)
                    maps = (np.full((K, E, g.n1r), -1, np.int32)
                            if g.lsoln else None)
                    for index, s, m in blocks:
                        valid = index >= 0  # drop padding columns
                        scores[:, index[valid]] = s[:, valid]
                        if g.lsoln:
                            maps[:, index[valid]] = m[:, valid]
                arrays.append([(scores[k].copy(), None if maps is None
                                else maps[k, :, :q.order].copy())
                               for k, q in enumerate(g.queries)])
        finally:
            trace.end(sp, nbytes)
        return [[SearchResult(scores=s, ssemaps=m, names=self.db.names,
                              orders=self.db.orders, query_order=q.order,
                              maxstart=self.maxstart)
                 for q, (s, m) in zip(g.queries, outs)]
                for g, outs in zip(launched, arrays)]

    def search(self, query, tag: int, *, lorder: bool,
               lsoln: bool) -> SearchResult:
        """Search one query under ``tag``, eagerly or by replaying its
        key's graph (``graphs``): the same results, bit for bit."""
        key = (round8(query.order), lorder, lsoln)
        captured = self.graphs.get(key)
        group = self.launch([query], [tag], lorder=lorder, lsoln=lsoln,
                            group=captured)
        (result,) = self.drain([group])[0]
        if captured is None and self.capture is not None and group.steps:
            if key in self.seen:
                group.steps[0].capture(group.staging.buf, [tag],
                                       self.capture)
                self.graphs[key] = group
            self.seen.add(key)
        return result


def search_db_many(queries, db, shards: list[Plan], *, query_tags,
                   lorder: bool = True, lsoln: bool = True,
                   **kw) -> list[SearchResult]:
    """Search queries that share round8(order) under ``query_tags``: one
    launch and its drain (``Searcher``'s keywords)."""
    searcher = Searcher(db, shards, **kw)
    return searcher.drain([searcher.launch(queries, query_tags,
                                           lorder=lorder, lsoln=lsoln)])[0]


def search_db(query, db, shards: list[Plan], *,
              query_tag: int = 0, **kw) -> SearchResult:
    """Search the whole packed DB for one query; results in database
    file order."""
    return search_db_many([query], db, shards, query_tags=[query_tag],
                          **kw)[0]
