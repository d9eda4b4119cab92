"""The system under test: cuda_satabsearch_tpu_torch's session API, as a
user drives it.

A call resolves each query by name from the resident DB
(``SearchSession.resolve_query``, the query-list mode), searches it
(``search`` for one query, ``search_many`` for a list, each ending in
its drain) and ranks the hits through ``stats.gumbel.score_stats``
(norm2, z, p).  Query tags follow the order of the queries in the
session, as the program numbers them; ``search`` is given its tag.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass

import numpy as np


@dataclass
class Answer:
    """One query's results as the timed path produced them."""

    tag: int
    query: int  # entry index of the query in the DB file
    order: int
    scores: np.ndarray  # int32 [E], DB file order
    names: list  # the entry names, file order
    maps: np.ndarray | None  # int32 [E, n1] under LSOLN
    stats: tuple  # (norm2, z, p) float64 [E] each


class Program:
    def __init__(self, db_path, config: dict, seed: int, device: str,
                 span=None):
        from cuda_satabsearch_tpu_torch.ops import sa_kernel
        from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                         SessionConfig)
        from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats

        self.score_stats = score_stats
        self._kernel = sa_kernel
        self.span = span or (lambda name: contextlib.nullcontext())
        cfg = SessionConfig(maxstart=int(config["maxstart"]), seed=seed,
                            device="cpu" if device == "cpu" else None)
        self.session = SearchSession(str(db_path), cfg)
        self.next_tag = 0

    def info(self) -> dict:
        s = self.session
        return {"load_ms": s.load_ms, "warmup_s": s.warmup_s,
                "upload_ms": s.upload_ms}

    def launches(self) -> int:
        return self._kernel.sa_search.launches

    def call(self, names: list[str], indices: list[int], *, loop: str,
             lorder: bool, lsoln: bool) -> list[Answer]:
        with self.span("satbench.resolve"):
            qs = [self.session.resolve_query(n) for n in names]
        if any(q is None for q in qs):
            raise KeyError(f"a query of {names} is not in the DB")
        tags = list(range(self.next_tag, self.next_tag + len(qs)))
        self.next_tag += len(qs)
        with self.span("satbench.search"):
            if loop == "search":
                results = [self.session.search(qs[0], lorder=lorder,
                                               lsoln=lsoln,
                                               query_tag=tags[0])]
            else:
                results = self.session.search_many(qs, lorder=lorder,
                                                   lsoln=lsoln)
        with self.span("satbench.stats"):
            stats = [self.score_stats(r.scores, q.order, r.orders)
                     for q, r in zip(qs, results)]
        return [Answer(tag=t, query=i, order=q.order, scores=r.scores,
                       names=r.names, maps=r.ssemaps if lsoln else None,
                       stats=st)
                for t, i, q, r, st in zip(tags, indices, qs, results, stats)]

    def close(self) -> None:
        """Free the session and its device state."""
        self.session = None
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
