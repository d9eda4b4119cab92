"""Bucket dispatch: resident bucket tensors, a launch plan per shard, and
the search step of one round8 group against one shard.

Counterpart of cuda_satabsearch_tpu/ops/pallas_search.py
(``prepare_bucket_pallas2`` :137-194, ``dispatch_db_pallas2[_multi]`` /
``assemble_db_pallas2[_multi]`` :549-717), without the TPU's chunk
plan, entry groups, query scatters and packed int8 drains: each bucket
is uploaded once as plain tensors (whole, or as shards over a mesh of
devices, parallel/mesh.py), with its entries' file-order indices, and
each shard gets a launch plan (``make_plan``).  A ``Step`` runs the K
queries of one round8 group against a plan in tiles of at most
``K_TILE`` queries (as the JAX package tiles K,
ops/pallas_search.py:497-520, without its power-of-two tail tiles,
which exist for the TPU's compiles), each tile in at most two kernel
launches, one per launch class (the narrow buckets, d2 <= 32, and the
wide ones), its chains' restarts split over several CTAs where the
launch would fill few waves of the card (ops/sa_kernel.restart_split),
each chain on several lanes where an unsplit launch pair fits in one
wave (ops/sa_kernel.chain_lanes), and gathers the outputs into file
order on the device.  Nothing waits until ``Step.results``, so that a
stream of groups is launched whole before its one drain
(ops/search.py).  A CUDA graph is a captured
``Step.launch``, replayed in its place.
"""

from __future__ import annotations

import functools
import gc
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from ..parallel.distributed import to_host
from .common import pack_tab, prepare_query
from .engine import search_plan_plain
from .rng import M32
from .sa_kernel import (MAX_BUCKETS, class_slots, descriptor, device_guard,
                        restart_split, sa_search)

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
    # (n1r, c_par, lsoln, lanes per chain) -> CTA slots of one launch
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
    output column, at most two launch classes, the wide one first, and
    the order that puts the columns in file order."""

    device: torch.device
    buckets: list[DeviceBucket]  # output order
    index: np.ndarray  # int32 [E]: concatenated bucket indices
    classes: list[LaunchClass]
    sms: int  # the device's SMs; 0 off a card
    # the columns a step gathers, by file index with padding last (every
    # rank's shard keeps its width), or a whole DB's without padding:
    # int64 [W] on the device, and the file index of each, int32 [W]
    order: torch.Tensor
    file_index: np.ndarray
    whole: bool  # file_index is 0 .. nentries - 1 of the DB (make_plan)

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


def make_plan(buckets: list[DeviceBucket], device=None,
              nentries: int | None = None) -> Plan:
    """The launch plan of ``buckets`` (any subset of a shard's buckets,
    on one device; outputs in the given order): buckets of d2 <=
    NARROW_MAX form the narrow launch class, the others the wide one,
    each ordered widest first so that the longest chains start first.
    ``nentries``: the buckets are a whole DB of that many entries, which
    the plan must hold each exactly once (padding aside), or ValueError;
    its steps' results are then in the DB's file order as they stand.
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
    cols = np.argsort(np.where(index < 0, np.iinfo(np.int32).max, index),
                      kind="stable")
    if nentries is not None:
        cols = cols[:nentries]
        if not np.array_equal(index[cols], np.arange(nentries)):
            raise ValueError("the plan does not hold every entry exactly "
                             "once")
    return Plan(device=device, buckets=buckets, index=index, classes=classes,
                sms=sm_count(device), order=torch.from_numpy(cols).to(device),
                file_index=index[cols], whole=nentries is not None)


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
    """Where K queries padded to n1r and their tags lie in one byte
    buffer, as the kernel reads them: [(dtype, shape, offset, bytes)] of
    qtypes int8[K, n1r], qtab uint8[K, n1r, n1r], qdmat f32[K, n1r, n1r],
    n1s int32[K] and tags int32[K] (the uint32 value tag & 0xffffffff,
    as ops/sa_kernel.upload_tags makes them), each 256-byte aligned, and
    the buffer's size in bytes."""
    layout, at = [], 0
    for dtype, shape in ((np.int8, (K, n1r)), (np.uint8, (K, n1r, n1r)),
                         (np.float32, (K, n1r, n1r)), (np.int32, (K,)),
                         (np.int32, (K,))):
        nbytes = np.dtype(dtype).itemsize * math.prod(shape)
        layout.append((dtype, shape, at, nbytes))
        at += -(-nbytes // 256) * 256
    return layout, at


_TORCH_DTYPE = {np.int8: torch.int8, np.uint8: torch.uint8,
                np.float32: torch.float32, np.int32: torch.int32}


def query_parts(buf, K: int, n1r: int) -> list:
    """The five parts of ``query_layout(K, n1r)`` as views of ``buf``, a
    uint8 numpy array or tensor."""
    tensor = torch.is_tensor(buf)
    return [buf[o:o + n].view(_TORCH_DTYPE[d] if tensor else d).reshape(s)
            for d, s, o, n in query_layout(K, n1r)[0]]


class Staging:
    """A zeroed host buffer ``buf`` of ``query_layout(K, n1r)``, in pinned
    memory where ``pin`` (PyTorch's caching host allocator serves it), so
    that its upload need not wait for the device, and numpy views of its
    parts, which ``stage`` writes."""

    def __init__(self, K: int, n1r: int, pin: bool):
        self.buf = torch.zeros(query_layout(K, n1r)[1], dtype=torch.uint8,
                               pin_memory=pin)
        self.parts = query_parts(self.buf.numpy(), K, n1r)


def stage(staging: Staging, queries, tags) -> None:
    """Write K queries and their tags into ``staging`` (its gaps stay
    zero).  Distances off the bf16 grid raise ValueError."""
    parts = staging.parts
    n1r = parts[0].shape[1]
    for k, q in enumerate(queries):
        parts[0][k], parts[1][k], parts[2][k] = prepare_query(q, n1r)
        parts[3][k] = q.order
    if not on_bf16_grid(parts[2]):
        raise ValueError("query distances are not on the bf16 grid "
                         "(pack queries with io/pack.pack_query)")
    parts[4].view(np.uint32)[:] = [t & M32 for t in tags]


def pack_queries(queries, n1r: int, device):
    """(qtypes int8[K, n1r], qtab uint8[K, n1r, n1r], qdmat
    f32[K, n1r, n1r], n1s int32[K]) for K queries padded to n1r, staged
    (``stage``, every tag 0) and uploaded in one copy."""
    K = len(queries)
    staging = Staging(K, n1r, pin=False)
    stage(staging, queries, [0] * K)
    return tuple(query_parts(staging.buf.to(device), K, n1r)[:4])


def tiles(K: int) -> list[slice]:
    """The query tiles of a K-query group: slices of at most ``K_TILE``
    queries, in order (the last one may be shorter)."""
    return [slice(k, min(k + K_TILE, K)) for k in range(0, K, K_TILE)]


def capture_graph(fn):
    """Capture the device work of ``fn()`` as a CUDA graph; returns the
    graph's replay (the tensors ``fn`` allocates stay in the graph's
    private memory pool).  No garbage is collected while capturing: a
    pinned buffer freed then would record an event, which the capture
    forbids."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        if collecting:
            gc.enable()
    return graph.replay


def to_file_order(order: torch.Tensor, outs, host=None) -> tuple:
    """A step's outputs (scores, maps or None) gathered on their device
    into the plan columns ``order`` (``Plan.order``: file order), and
    their non-blocking copy into ``host`` (pinned buffers of the gathered
    shapes) started, if given.  Returns the gathered tensors.  ``gather``,
    not ``index_select``: the kernel is the same at every size, so a
    start-up's small gather loads it (index_select picks its kernel by
    size, and its first use in a process can take over 100 ms)."""
    out = tuple(None if x is None else x.gather(1, order.view(
        1, -1, *(1,) * (x.dim() - 2)).expand(
            x.shape[0], len(order), *x.shape[2:])) for x in outs)
    for h, d in zip(host or (), out):
        if d is not None:
            h.copy_(d, non_blocking=True)
    return out


class Step:
    """K queries of one round8 group, padded to n1r, against one shard's
    plan, on the current stream of the plan's device.  ``backend``
    "cuda" runs the kernel's wrapper (ops/sa_kernel.py), "torch" the
    plain engine (ops/engine.py), with ``kw`` (lorder, lsoln, seed,
    c_par, r_seq, params).  ``gather``: ``results`` all-gathers the
    shards of the other ranks of a multi-process run
    (parallel/distributed.to_host; every rank drains the same groups in
    the same order, so the collectives match)."""

    def __init__(self, plan: Plan, K: int, n1r: int, *, backend: str,
                 gather: bool = False, **kw):
        self.plan, self.K, self.n1r, self.kw = plan, K, n1r, kw
        self.backend, self.gather = backend, gather
        pin = plan.device.type == "cuda"
        W = len(plan.file_index)
        self.host = None if gather else (  # file order, on the host

            torch.empty((K, W), dtype=torch.int32, pin_memory=pin),
            torch.empty((K, W, n1r), dtype=torch.int32, pin_memory=pin)
            if kw["lsoln"] else None)
        self.event = torch.cuda.Event() if pin else None
        self.out = None  # the file-order scores and maps on the device
        self.replay = None  # the captured launch (``capture``)
        # its SA launches, the split ones and those with lanes
        self.launches = (0, 0, 0)

    def launch(self, staged: torch.Tensor, tags) -> None:
        """The step's device work on the current stream, which a capture
        holds: one copy of ``staged`` (``Staging.buf``) to the device, one
        engine call per query tile in its ``kernel_search.enqueue`` span
        (``tags`` name the spans), the tiles joined, one gather into file
        order (``Plan.order``) and, unless gathered, one non-blocking
        copy of scores (and maps) to the host.  Each query keeps its own
        tag, so the results do not depend on the tiling."""
        plan = self.plan
        *q, qtags = query_parts(staged.to(plan.device, non_blocking=True),
                                self.K, self.n1r)
        fn = {"cuda": sa_search, "torch": search_plan_plain}[self.backend]
        parts = [self.enqueue(functools.partial(
                     fn, *(x[t] for x in q), plan, tags=qtags[t], **self.kw),
                     tags[t.start], t.stop - t.start)
                 for t in tiles(self.K)]
        s, m = parts[0] if len(parts) == 1 else (
            torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]) if self.kw["lsoln"] else None)
        self.out = to_file_order(plan.order, (s, m), self.host)

    def enqueue(self, run, tag: int, K: int):
        """``run()`` in a ``kernel_search.enqueue`` span of K queries that
        carries the figures of the SA launches that K of the step's
        queries make (``launch_figures``) and their n1r."""
        sp = trace.begin("kernel_search.enqueue", tag, K)
        figures = trace.NO_FIGURES
        try:
            out = run()
            if sp is not None:
                kw = self.kw
                figures = (*launch_figures(
                    self.plan, K, self.n1r, c_par=kw["c_par"],
                    r_seq=kw["r_seq"], lsoln=kw["lsoln"],
                    maxiter=kw["params"].maxiter), self.n1r)
            return out
        finally:
            trace.end(sp, 0, figures)

    def run(self, staged: torch.Tensor, tags) -> None:
        """``launch``, or replay its capture in one ``enqueue`` span (its
        SA launches counted as the capture made them), on the plan's
        device; then record the event that ``results`` waits for."""
        with device_guard(self.plan.device):
            if self.replay is None:
                self.launch(staged, tags)
            else:
                self.enqueue(self.replay, tags[0], self.K)
                sa_search.launches += self.launches[0]
                sa_search.split_launches += self.launches[1]
                sa_search.lane_launches += self.launches[2]
            if self.event is not None:
                self.event.record()

    def capture(self, staged: torch.Tensor, tags,
                capture=capture_graph) -> None:
        """Capture ``launch(staged, tags)`` for ``run`` to replay from then
        on (``staged`` and the step's buffers live as long): no span is
        recorded while capturing, and each replay, not the capture,
        counts the SA launches."""
        before = (sa_search.launches, sa_search.split_launches,
                  sa_search.lane_launches)

        def quiet():
            with trace.paused():
                self.launch(staged, tags)

        with device_guard(self.plan.device):
            self.replay = capture(quiet)
        self.launches = (sa_search.launches - before[0],
                         sa_search.split_launches - before[1],
                         sa_search.lane_launches - before[2])
        (sa_search.launches, sa_search.split_launches,
         sa_search.lane_launches) = before

    def results(self):
        """(``Plan.file_index``, scores int32 [K, W], maps int32 [K, W, n1r]
        or None) of the launched step, on the host once the device is
        done; every rank's, concatenated, when gathered."""
        if self.gather:
            s, m = self.out
            index = torch.from_numpy(self.plan.file_index).to(s.device)
            return (to_host(index), to_host(s, dim=1),
                    None if m is None else to_host(m, dim=1))
        if self.event is not None:
            self.event.synchronize()
        s, m = self.host
        return (self.plan.file_index, s.numpy(),
                None if m is None else m.numpy())
