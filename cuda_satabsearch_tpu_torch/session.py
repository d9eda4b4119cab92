"""Search session: a resident packed+uploaded DB and a query stream.

Counterpart of cuda_satabsearch_tpu/session.py (the analog of the
reference host program's lifecycle, cudaSaTabsearch.cu main
:573-1340): parse and pack the DB once, upload it to the device once,
then run any number of queries against it.  ``format_results`` and
``print_query_header`` are copies of the JAX package's, byte for byte.

On a card the session launches the start-up kernel once
(core/warmup.py) after the DB load and before the upload, as the JAX
package orders load -> warm -> upload: it brings up the CUDA context and
the kernel library (built with nvcc at first use) and reports its time
on stderr.  There is no compile cache.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import torch

from .core.constants import DEFAULT_MAXSTART, DEFAULTS, MAXDIM, SAParams
from .core.warmup import warm_backend
from .io.pack import (DEFAULT_BUCKETS, PackedDB, PackedQuery,
                      pack_database, pack_query)
from .io.parser import TableauEntry, read_database
from .ops.common import round8
from .ops.search import (SearchResult, resolve_backend, search_db_many,
                         upload_db)
from .stats.gumbel import score_stats


@dataclass
class SessionConfig:
    maxstart: int = DEFAULT_MAXSTART
    seed: int = 1234
    c_max: int = 128
    buckets: tuple = DEFAULT_BUCKETS
    maxdim: int = MAXDIM
    params: SAParams = DEFAULTS
    backend: str = "auto"  # "cuda" (kernel) | "torch" (plain) | "auto"
    device: str | None = None  # "cpu" for the plain engine on the CPU
    compat_z: bool = False  # reproduce the reference's int-truncated z


class SearchSession:
    def __init__(self, dbfile: str, config: SessionConfig | None = None,
                 entries: list[TableauEntry] | None = None):
        self.config = config or SessionConfig()
        self.dbfile = dbfile
        # fail on a missing card before the DB is read
        self.backend, self.device = resolve_backend(self.config.backend,
                                                    self.config.device)

        t0 = time.perf_counter()
        if entries is None:
            entries = read_database(dbfile, maxdim=self.config.maxdim)
        self.db: PackedDB = pack_database(entries, self.config.buckets)
        self.load_ms = (time.perf_counter() - t0) * 1000.0

        # after the DB load: a missing or bad dbfile fails before the
        # device is touched
        self.warmup_s = (warm_backend(self.device)
                         if self.backend == "cuda" else 0.0)

        t0 = time.perf_counter()
        self.device_db = upload_db(self.db, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_ms = (time.perf_counter() - t0) * 1000.0
        self._query_tag = 0

    @property
    def nentries(self) -> int:
        return self.db.nentries

    def resolve_query(self, name: str) -> PackedQuery | None:
        """Resolve a query by identifier from the resident DB (query-list
        mode, cudaSaTabsearch.cu:730-788)."""
        loc = self.db.lookup(name)
        if loc is None:
            return None
        return pack_query(self.db.entry(*loc))

    def _kw(self, lorder: bool, lsoln: bool) -> dict:
        cfg = self.config
        return dict(maxstart=cfg.maxstart, lorder=lorder, lsoln=lsoln,
                    seed=cfg.seed, c_max=cfg.c_max, backend=self.backend,
                    params=cfg.params)

    def search_many(self, queries, *, lorder: bool = True,
                    lsoln: bool = False) -> list[SearchResult]:
        """Search a stream of queries.  Each query's RNG tag is its
        position in the stream (as the JAX package's ``-c`` path
        numbers them); queries are grouped by round8(order), and each
        group runs in one launch per bucket."""
        tags = list(range(self._query_tag, self._query_tag + len(queries)))
        self._query_tag += len(queries)
        groups: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            groups.setdefault(round8(q.order), []).append(i)
        out: list = [None] * len(queries)
        for idxs in groups.values():
            results = search_db_many(
                [queries[i] for i in idxs], self.db, self.device_db,
                query_tags=[tags[i] for i in idxs],
                **self._kw(lorder, lsoln))
            for i, res in zip(idxs, results):
                out[i] = res
        return out

    def search(self, query: PackedQuery, *, lorder: bool = True,
               query_tag: int | None = None,
               lsoln: bool = True) -> SearchResult:
        if query_tag is None:
            query_tag = self._query_tag
        self._query_tag = query_tag + 1
        return search_db_many([query], self.db, self.device_db,
                              query_tags=[query_tag],
                              **self._kw(lorder, lsoln))[0]


def format_results(result: SearchResult, qn: int, *, lsoln: bool,
                   compat_z: bool = False, out=None) -> None:
    """Emit result lines ``name rawscore norm2 z p`` (+ 1-based ssemap
    pair lines under LSOLN), byte-compatible with the reference's
    ``%-8s %d %g %g %g`` / ``%3d %3d`` (cudaSaTabsearch.cu:1102-1114)."""
    out = out or sys.stdout
    scores = result.scores
    n2s, z, p = score_stats(scores, qn, result.orders, compat=compat_z)
    lines = []
    for i in range(result.nentries):
        lines.append("%-8s %d %g %g %g\n"
                     % (result.names[i], scores[i], n2s[i], z[i], p[i]))
        if lsoln:
            for k in range(qn):
                j = result.ssemaps[i, k]
                if j >= 0:
                    lines.append("%3d %3d\n" % (k + 1, j + 1))
    out.write("".join(lines))


def print_query_header(program: str, ltype: bool, lorder: bool, lsoln: bool,
                       qid: str, dbfile: str, out=None) -> None:
    """The '#' metadata headers downstream eval scripts key on
    (cudaSaTabsearch.cu:1027-1030; mkroctabs.py splits on '# QUERY ID =')."""
    out = out or sys.stdout
    tf = lambda b: "T" if b else "F"
    out.write("# %s LTYPE = %s LORDER = %s LSOLN = %s\n"
              % (program, tf(ltype), tf(lorder), tf(lsoln)))
    out.write("# QUERY ID = %-8s\n" % qid)
    out.write("# DBFILE = %-80s\n" % dbfile)
