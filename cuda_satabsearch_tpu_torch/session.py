"""Search session: a resident packed+uploaded DB and a query stream.

Counterpart of cuda_satabsearch_tpu/session.py (the analog of the
reference host program's lifecycle, cudaSaTabsearch.cu main
:573-1340): parse and pack the DB once, upload it to the device once,
then run any number of queries against it.  ``format_results`` and
``print_query_header`` are copies of the JAX package's, byte for byte.

A DB file is parsed and packed by the native C++ loader (io/native.py,
built with the host compiler at first use) as in the JAX package, or
in Python where ``SATAB_NATIVE=0`` or no compiler exists (one stderr
line says why).  With ``use_mesh`` the DB's entries are sharded over a
mesh of devices (parallel/mesh.py), across the processes of a
multi-process run too (parallel/distributed.py).

On a card the session brings up each device once (core/warmup.py:
the start-up kernel, the SA kernel's module, a search's launch path)
after the DB load and before the upload, as the JAX package orders
load -> warm -> upload, and reports the times on stderr.  There is no
compile cache.
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
from .io import native
from .io.parser import TableauEntry, read_database
from .ops.common import round8
from .parallel import distributed
from .parallel.mesh import make_mesh, mesh_shards
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
    use_mesh: bool = False  # shard the entry axis over a mesh of devices
    devices: list | None = None  # the mesh (default: all CUDA devices)


class SearchSession:
    def __init__(self, dbfile: str, config: SessionConfig | None = None,
                 entries: list[TableauEntry] | None = None):
        cfg = self.config = config or SessionConfig()
        self.dbfile = dbfile
        # fail on a missing card before the DB is read
        self.mesh = make_mesh(cfg.devices) if cfg.use_mesh else None
        self.backend, self.device = resolve_backend(
            cfg.backend, self.mesh[0] if self.mesh else cfg.device)
        # the shards of every rank, when they span processes
        self.gather = self.mesh is not None and distributed.world_size() > 1
        pad_to = mesh_shards(self.mesh)[1] if self.mesh else 1

        t0 = time.perf_counter()
        if entries is not None:
            self.db = pack_database(entries, cfg.buckets, pad_to=pad_to)
        else:
            self.db = _load_db(dbfile, cfg, pad_to)
        self.load_ms = (time.perf_counter() - t0) * 1000.0

        # after the DB load: a missing or bad dbfile fails before the
        # device is touched
        devices = list(dict.fromkeys(self.mesh or [self.device]))
        self.warmup_s = (sum(warm_backend(d) for d in devices)
                         if self.backend == "cuda" else 0.0)

        t0 = time.perf_counter()
        self.device_db = upload_db(self.db, self.mesh or self.device)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
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
                    gather=self.gather, params=cfg.params)

    def search_many(self, queries, *, lorder: bool = True,
                    lsoln: bool = False) -> list[SearchResult]:
        """Search a stream of queries.  Each query's RNG tag is its
        position in the stream (as the JAX package's ``-c`` path
        numbers them); queries are grouped by round8(order), and each
        group runs in at most two launches per shard."""
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


def _load_db(dbfile: str, cfg: SessionConfig, pad_to: int) -> PackedDB:
    """Parse and pack a DB file: natively (io/native.py) where the
    loader can be built, else in Python."""
    why = native.unavailable()
    if why is None:
        return native.pack_database_file(dbfile, cfg.buckets,
                                         maxdim=cfg.maxdim, pad_to=pad_to)
    print(f"# native DB loader not used ({why}): parsing in Python",
          file=sys.stderr)
    return pack_database(read_database(dbfile, maxdim=cfg.maxdim),
                         cfg.buckets, pad_to=pad_to)


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
