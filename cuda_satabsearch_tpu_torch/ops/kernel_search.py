"""Bucket dispatch: resident bucket tensors, a launch plan per shard,
results scattered back to file order.

Counterpart of cuda_satabsearch_tpu/ops/pallas_search.py
(``prepare_bucket_pallas2`` :137-194, ``dispatch_db_pallas2[_multi]`` /
``assemble_db_pallas2[_multi]`` :549-717), without the TPU's chunk
plan, entry groups, query scatters and packed int8 drains: each bucket
is uploaded once as plain tensors (whole, or as shards over a mesh of
devices, parallel/mesh.py), with its entries' file-order indices, and
each shard gets a launch plan (``make_plan``).  The K queries of one
round8 group run against a shard in tiles of at most ``K_TILE`` queries
(as the JAX package tiles K, ops/pallas_search.py:497-520, without its
power-of-two tail tiles, which exist for the TPU's compiles), each tile
in at most two kernel launches, one per launch class (the narrow
buckets, d2 <= 32, and the wide ones), each writing its columns of one
int32[K, E_shard] output, its chains' restarts split over several CTAs
where the launch would fill few waves of the card
(ops/sa_kernel.restart_split); scores and maps come back as int32.  As
the JAX package's dispatch / assemble pair is split, ``launch_group``
launches a group and ``drain`` brings any number of launched groups
back, so that a stream of groups is launched whole before its one
drain.  ``QueryGraphs`` runs one query against one shard, from its
staging to its drain, as a CUDA graph replayed per query width.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from ..core.constants import DEFAULTS, SAParams
from ..parallel.distributed import to_host
from .common import pack_tab, prepare_query, round8
from .engine import search_plan_plain
from .rng import M32
from .sa_kernel import (MAX_BUCKETS, class_slots, descriptor, device_guard,
                        restart_split, sa_search, upload_tags)

NARROW_MAX = 32  # widest bucket of the narrow launch class
# queries of one launch: the JAX package's K_TILE (ops/pallas_search.py
# :497); a launch's grid holds at most 65,535 queries
K_TILE = 64


@dataclass
class DeviceBucket:
    """One size bucket resident on a device, in the kernel's format."""

    dim: int  # padded SSE dimension d2
    types: torch.Tensor  # int8 [E, d2]
    tab: torch.Tensor  # uint8 [E, d2, d2], hi*8 + lo
    dmat: torch.Tensor  # float32 [E, d2, d2], on the bf16 grid
    n2: torch.Tensor  # int32 [E]
    index: np.ndarray  # int32 [E] file-order position, -1 = padding
    index_dev: torch.Tensor  # the same, on the device (the kernel's keys)


@dataclass
class LaunchClass:
    """Buckets that run in one kernel launch, widest first."""

    buckets: list  # [(DeviceBucket, first output column)]
    d2max: int  # the widest bucket: sizes the launch's shared memory
    desc: object  # the kernel's descriptor (ops/sa_kernel.descriptor)
    # (n1r, c_par, lsoln) -> CTA slots of one launch
    # (ops/sa_kernel.class_slots)
    slots: dict = field(default_factory=dict)

    @property
    def entries(self) -> int:
        """Rows of the class's buckets, padding included: its CTAs per
        query and restart split (ops/sa_kernel.restart_split)."""
        return sum(len(b.index) for b, _ in self.buckets)


@dataclass
class Plan:
    """A shard's launch plan: its buckets, the file-order index of each
    output column, and at most two launch classes, the wide one first."""

    device: torch.device
    buckets: list[DeviceBucket]  # output order
    index: np.ndarray  # int32 [E]: concatenated bucket indices
    classes: list[LaunchClass]
    sms: int  # the device's SMs; 0 off a card

    @property
    def nentries(self) -> int:
        return len(self.index)


def on_bf16_grid(x: np.ndarray) -> bool:
    """Whether every float32 of ``x`` is a bfloat16 value (the kernel
    stages distances as bf16, io/pack.quantize_dmat)."""
    return not np.any(np.ascontiguousarray(x, np.float32).view(np.uint32)
                      & 0xFFFF)


def prepare_bucket(bucket, device, rows: slice = slice(None)
                   ) -> DeviceBucket:
    """Upload rows ``rows`` of a PackedBucket (from either package's
    packer: the fields and dtypes are the same) once."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x[rows])).to(device)

    if not on_bf16_grid(bucket.dmat[rows]):
        raise ValueError("bucket distances are not on the bf16 grid "
                         "(pack the DB with io/pack.py)")
    index = np.asarray(bucket.index, np.int32)
    return DeviceBucket(
        dim=bucket.dim,
        types=put(bucket.types.astype(np.int8)),
        tab=put(pack_tab(bucket.tabhi, bucket.tablo).astype(np.uint8)),
        dmat=put(bucket.dmat.astype(np.float32)),
        n2=put(bucket.orders.astype(np.int32)),
        index=index[rows],
        index_dev=put(index))


def make_plan(buckets: list[DeviceBucket], device=None) -> Plan:
    """The launch plan of ``buckets`` (any subset of a shard's buckets,
    on one device; outputs in the given order): buckets of d2 <=
    NARROW_MAX form the narrow launch class, the others the wide one,
    each ordered widest first so that the longest chains start first.
    ``device`` is needed only for a plan without buckets."""
    buckets = [b for b in buckets if len(b.index)]
    device = buckets[0].types.device if buckets else torch.device(device)
    offsets = np.cumsum([0] + [len(b.index) for b in buckets])
    classes = []
    for wide in (True, False):
        members = sorted(((b, int(o)) for b, o in zip(buckets, offsets)
                          if (b.dim > NARROW_MAX) == wide),
                         key=lambda m: -m[0].dim)
        if len(members) > MAX_BUCKETS:
            raise ValueError(f"{len(members)} buckets in one launch class; "
                             f"the kernel takes {MAX_BUCKETS}")
        if members:
            classes.append(LaunchClass(buckets=members,
                                       d2max=members[0][0].dim,
                                       desc=descriptor(members)))
    index = (np.concatenate([b.index for b in buckets]) if buckets
             else np.zeros(0, np.int32))
    return Plan(device=device, buckets=buckets, index=index, classes=classes,
                sms=sm_count(device))


def sm_count(device: torch.device) -> int:
    """The SMs of CUDA device ``device``; 0 for any other device."""
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_figures(plan: Plan, K: int, n1r: int, *, c_par: int, r_seq: int,
                   lsoln: bool, maxiter: int) -> tuple[int, int, int]:
    """(ctas, cta_slots, chain_moves) of the SA launches that K queries
    padded to n1r make against ``plan`` (one per launch class, each
    split S ways by ops/sa_kernel.restart_split; the plain engine runs
    the same plan unsplit): the CTAs of their grids, one per (column,
    query, split); their CTA slots (``class_slots``), summed; and the
    dependent moves of a chain in one CTA, maxiter x r_seq / S, the same
    in every launch.  The figures of a ``kernel_search.enqueue`` span."""
    split = restart_split(plan, K, n1r, c_par=c_par, r_seq=r_seq,
                          lsoln=lsoln)
    return (K * plan.nentries * split,
            sum(class_slots(plan, cls, n1r, c_par, lsoln)
                for cls in plan.classes),
            maxiter * r_seq // split)


def query_layout(K: int, n1r: int):
    """Where K queries padded to n1r lie in one byte buffer, as the kernel
    reads them: [(dtype, shape, offset, bytes)] of qtypes int8[K, n1r],
    qtab uint8[K, n1r, n1r], qdmat f32[K, n1r, n1r] and n1s int32[K],
    each 256-byte aligned, and the buffer's size in bytes."""
    layout, at = [], 0
    for dtype, shape in ((np.int8, (K, n1r)), (np.uint8, (K, n1r, n1r)),
                         (np.float32, (K, n1r, n1r)), (np.int32, (K,))):
        nbytes = np.dtype(dtype).itemsize * math.prod(shape)
        layout.append((dtype, shape, at, nbytes))
        at += -(-nbytes // 256) * 256
    return layout, at


_TORCH_DTYPE = {np.int8: torch.int8, np.uint8: torch.uint8,
                np.float32: torch.float32, np.int32: torch.int32}


def query_parts(buf, K: int, n1r: int) -> list:
    """The four parts of ``query_layout(K, n1r)`` as views of ``buf``, a
    uint8 numpy array or tensor."""
    tensor = torch.is_tensor(buf)
    return [buf[o:o + n].view(_TORCH_DTYPE[d] if tensor else d).reshape(s)
            for d, s, o, n in query_layout(K, n1r)[0]]


def stage_queries(queries, views) -> None:
    """Write K queries, padded to n1r, into ``views``: the four parts of
    ``query_layout(K, n1r)`` in a numpy buffer whose gaps are zero
    (``query_parts``).  Distances off the bf16 grid raise ValueError."""
    n1r = views[0].shape[1]
    for k, q in enumerate(queries):
        views[0][k], views[1][k], views[2][k] = prepare_query(q, n1r)
        views[3][k] = q.order
    if not on_bf16_grid(views[2]):
        raise ValueError("query distances are not on the bf16 grid "
                         "(pack queries with io/pack.pack_query)")


def pack_queries(queries, n1r: int, device):
    """(qtypes int8[K, n1r], qtab uint8[K, n1r, n1r], qdmat
    f32[K, n1r, n1r], n1s int32[K]) for K queries padded to n1r, uploaded
    in one copy (views of one byte buffer, ``query_layout``)."""
    K = len(queries)
    buf = np.zeros(query_layout(K, n1r)[1], np.uint8)
    stage_queries(queries, query_parts(buf, K, n1r))
    return tuple(query_parts(torch.from_numpy(buf).to(device), K, n1r))


def tiles(K: int) -> list[slice]:
    """The query tiles of a K-query group: slices of at most ``K_TILE``
    queries, in order (the last one may be shorter)."""
    return [slice(k, min(k + K_TILE, K)) for k in range(0, K, K_TILE)]


@dataclass
class Launched:
    """A round8 group launched on every shard and not drained yet."""

    queries: list
    n1r: int
    lsoln: bool
    # per shard: (device, file-order index int32[E], scores int32[K, E],
    # maps int32[K, E, n1r] or None), the outputs still on the device
    outputs: list


def launch_group(queries, shards: list[Plan], *, lorder: bool, lsoln: bool,
                 seed: int, query_tags, c_par: int, r_seq: int, backend: str,
                 params: SAParams = DEFAULTS) -> Launched:
    """Launch K queries of one round8 group against every shard's plan
    (ops/search.upload_db), without waiting for any result.

    ``backend`` "cuda" runs the kernel's wrapper (ops/sa_kernel.py, at
    most two launches per shard and query tile), "torch" the plain
    engine (ops/engine.py), on each shard's device and current stream.
    The queries and their tags are uploaded once per shard; each tile
    of ``tiles(K)`` is one call, and a group of more than one tile has
    its tiles' outputs joined on the device.  Each query keeps its own
    tag, so the results do not depend on the tiling."""
    n1r = round8(max(q.order for q in queries))
    if any(round8(q.order) != n1r for q in queries):
        raise ValueError("queries of one call must share round8(order)")
    fn = {"cuda": sa_search, "torch": search_plan_plain}[backend]
    sp = trace.begin("kernel_search.launch_group", query_tags[0],
                     len(queries))
    try:
        outputs = []
        for plan in shards:
            if not plan.nentries:  # an empty DB
                continue
            q = pack_queries(queries, n1r, plan.device)
            tags = upload_tags(query_tags, plan.device)
            parts = []
            for t in tiles(len(queries)):
                tsp = trace.begin("kernel_search.enqueue",
                                  query_tags[t.start], t.stop - t.start)
                figures = trace.NO_FIGURES
                try:
                    parts.append(fn(*(x[t] for x in q), plan, seed=seed,
                                    tags=tags[t], c_par=c_par, r_seq=r_seq,
                                    lorder=lorder, lsoln=lsoln,
                                    params=params))
                    if tsp is not None:
                        figures = launch_figures(
                            plan, t.stop - t.start, n1r, c_par=c_par,
                            r_seq=r_seq, lsoln=lsoln, maxiter=params.maxiter)
                finally:
                    trace.end(tsp, 0, figures)
            s, m = parts[0] if len(parts) == 1 else (
                torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]) if lsoln else None)
            outputs.append((plan.device, plan.index, s, m))
        return Launched(queries=list(queries), n1r=n1r, lsoln=lsoln,
                        outputs=outputs)
    finally:
        trace.end(sp)


def drain(launched: list[Launched], nentries: int, gather: bool = False):
    """Bring the outputs of launched groups to the host, in launch order:
    the stream's only wait for the device.  ``gather``: the shards of
    the other ranks of a multi-process run are all-gathered
    (parallel/distributed.to_host; every rank drains the same groups in
    the same order, so the collectives match).  Returns, per group,
    [(scores int32[nentries], maps int32[nentries, n1] or None)] in
    query order, entries in database file order.  The bytes of scores
    and maps brought to the host are recorded on the
    ``kernel_search.drain`` span (trace.py)."""
    sp = trace.begin("kernel_search.drain")
    nbytes = 0
    try:
        out = []
        for group in launched:
            K, lsoln = len(group.queries), group.lsoln
            scores = np.zeros((K, nentries), np.int32)
            maps = (np.full((K, nentries, group.n1r), -1, np.int32) if lsoln
                    else None)
            for dev, index, s, m in group.outputs:  # one copy per output
                if gather:
                    index = to_host(torch.from_numpy(index).to(dev))
                    s = to_host(s, dim=1)
                    m = to_host(m, dim=1) if lsoln else None
                else:
                    s = s.cpu().numpy()
                    m = m.cpu().numpy() if lsoln else None
                nbytes += s.nbytes + (m.nbytes if lsoln else 0)
                valid = index >= 0  # drop padding entries
                scores[:, index[valid]] = s[:, valid]
                if lsoln:
                    maps[:, index[valid]] = m[:, valid]
            out.append([(scores[k],
                         None if maps is None else maps[k, :, :q.order])
                        for k, q in enumerate(group.queries)])
        return out
    finally:
        trace.end(sp, nbytes)


# searches that QueryGraphs replayed, and the graphs it captured
graph_replays = 0
graph_captures = 0


def file_order(index: np.ndarray, nentries: int) -> np.ndarray:
    """The plan column of each entry in file order (int64 [nentries]):
    the inverse of a one-shard plan's ``index``, its padding columns
    (-1) dropped.  Raises ValueError unless the plan holds every entry
    exactly once."""
    cols = np.flatnonzero(index >= 0)
    inverse = np.full(nentries, -1, np.int64)
    inverse[index[cols]] = cols
    if len(cols) != nentries or (inverse < 0).any():
        raise ValueError("the plan does not hold every entry exactly once")
    return inverse


def capture_graph(fn):
    """Capture the device work of ``fn()`` as a CUDA graph; returns the
    graph's replay (the tensors ``fn`` allocates stay in the graph's
    private memory pool)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


@dataclass
class _Graph:
    """One key's captured search and the buffers it reads and writes by
    address, kept as long as the graph."""

    replay: object
    launches: int  # SA kernel launches of one replay
    split_launches: int  # those of them that split their restarts
    figures: tuple  # launch_figures of one replay
    staging: torch.Tensor  # uint8: the query in query_layout(1, n1r), the tag
    parts: list  # numpy views of the query's parts in ``staging``
    tag: np.ndarray  # uint32[1]: the tag's place in ``staging``
    device: torch.Tensor  # uint8: ``staging``'s copy on the device
    scores: torch.Tensor  # int32 [1, E], file order
    maps: torch.Tensor | None  # int32 [1, E, n1r], file order, under LSOLN


class QueryGraphs:
    """One query's search against a one-shard plan, from staging to drain,
    as one CUDA graph per key (n1r, lorder, lsoln), replayed.

    A graph holds one copy of the query's staging buffer (pinned host
    memory, ``query_layout`` and the tag) to the device; the
    ``sa_search`` call that ``launch_group`` makes, with the same seed,
    chains and params; the gather of the plan's columns into file order
    (``file_order``); and one copy of the file-order scores (and maps
    under LSOLN) into pinned host memory.  A key's first two searches
    take the eager path, so that a fresh process's first search pays no
    capture; the second captures the key's graph once its results are
    drained (``searched``), and every later one replays it (``search``).
    Searches run one at a time: each waits for its results before the
    next stages.  ``capture`` turns a function into a replay
    (``capture_graph`` on a card)."""

    def __init__(self, plan: Plan, nentries: int, *, seed: int, c_par: int,
                 r_seq: int, params: SAParams = DEFAULTS,
                 capture=capture_graph):
        self.plan = plan
        self.inverse = torch.from_numpy(file_order(plan.index, nentries)
                                        ).to(plan.device)
        self.search_kw = dict(seed=seed, c_par=c_par, r_seq=r_seq,
                              params=params)
        self.capture = capture
        self.pin = plan.device.type == "cuda"
        self.event = torch.cuda.Event() if self.pin else None
        self.seen: set = set()
        self.graphs: dict = {}

    def has(self, query, lorder: bool, lsoln: bool) -> bool:
        """Whether a search of ``query`` replays a graph."""
        return (round8(query.order), lorder, lsoln) in self.graphs

    def searched(self, query, lorder: bool, lsoln: bool) -> None:
        """Note an eager search of ``query``; at its key's second, capture
        the key's graph."""
        key = (round8(query.order), lorder, lsoln)
        if key in self.seen:
            with device_guard(self.plan.device):
                self._capture(key)
        self.seen.add(key)

    def _capture(self, key) -> None:
        global graph_captures
        n1r, lorder, lsoln = key
        size = query_layout(1, n1r)[1]
        staging = torch.zeros(size + 4, dtype=torch.uint8,
                              pin_memory=self.pin)
        dev = torch.empty_like(staging, device=self.plan.device)
        parts, tags = query_parts(dev, 1, n1r), dev[size:].view(torch.int32)
        E = len(self.inverse)
        scores = torch.empty((1, E), dtype=torch.int32, pin_memory=self.pin)
        maps = (torch.empty((1, E, n1r), dtype=torch.int32,
                            pin_memory=self.pin) if lsoln else None)

        def run():
            dev.copy_(staging, non_blocking=True)
            s, m = sa_search(*parts, self.plan, tags=tags, lorder=lorder,
                             lsoln=lsoln, **self.search_kw)
            scores.copy_(s.index_select(1, self.inverse), non_blocking=True)
            if lsoln:
                maps.copy_(m.index_select(1, self.inverse),
                           non_blocking=True)

        before = sa_search.launches, sa_search.split_launches
        replay = self.capture(run)
        launches = sa_search.launches - before[0]
        split_launches = sa_search.split_launches - before[1]
        sa_search.launches, sa_search.split_launches = before
        graph_captures += 1
        kw = self.search_kw
        figures = launch_figures(self.plan, 1, n1r, c_par=kw["c_par"],
                                 r_seq=kw["r_seq"], lsoln=lsoln,
                                 maxiter=kw["params"].maxiter)
        host = staging.numpy()
        self.graphs[key] = _Graph(
            replay, launches, split_launches, figures, staging,
            query_parts(host, 1, n1r),
            host[size:].view(np.uint32), dev, scores, maps)

    def search(self, query, tag: int, *, lorder: bool, lsoln: bool):
        """Search ``query`` under its tag by replaying its key's graph
        (``has``).  Returns (scores int32[E], maps int32[E, n1] or None),
        file order, in arrays of their own.  The spans are the eager
        path's: ``kernel_search.launch_group`` (the staging and the
        replay), ``kernel_search.enqueue`` (the replay, with the captured
        launches' figures) and
        ``kernel_search.drain`` (the wait and the copy-out, with the
        bytes brought to the host)."""
        global graph_replays
        g = self.graphs[(round8(query.order), lorder, lsoln)]
        sp = trace.begin("kernel_search.launch_group", tag, 1)
        try:
            stage_queries([query], g.parts)
            g.tag[0] = tag & M32
            esp = trace.begin("kernel_search.enqueue", tag, 1)
            try:
                with device_guard(self.plan.device):
                    g.replay()
                    if self.event is not None:
                        self.event.record()
            finally:
                trace.end(esp, 0, g.figures)
            graph_replays += 1
            sa_search.launches += g.launches
            sa_search.split_launches += g.split_launches
        finally:
            trace.end(sp)
        sp = trace.begin("kernel_search.drain")
        nbytes = 0
        try:
            if self.event is not None:
                self.event.synchronize()
            scores = g.scores.numpy()[0].copy()
            maps = (g.maps.numpy()[0, :, :query.order].copy() if lsoln
                    else None)
            nbytes = g.scores.nbytes + (g.maps.nbytes if lsoln else 0)
            return scores, maps
        finally:
            trace.end(sp, nbytes)
