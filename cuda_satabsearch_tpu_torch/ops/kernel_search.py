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
int32[K, E_shard] output; scores and maps come back as int32.  As the
JAX package's dispatch / assemble pair is split, ``launch_group``
launches a group and ``drain`` brings any number of launched groups
back, so that a stream of groups is launched whole before its one
drain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..core.constants import DEFAULTS, SAParams
from ..parallel.distributed import to_host
from .common import pack_tab, prepare_query, round8
from .engine import search_plan_plain
from .sa_kernel import MAX_BUCKETS, descriptor, sa_search, upload_tags

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


@dataclass
class Plan:
    """A shard's launch plan: its buckets, the file-order index of each
    output column, and at most two launch classes, the wide one first."""

    device: torch.device
    buckets: list[DeviceBucket]  # output order
    index: np.ndarray  # int32 [E]: concatenated bucket indices
    classes: list[LaunchClass]

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
    return Plan(device=device, buckets=buckets, index=index, classes=classes)


def pack_queries(queries, n1r: int, device):
    """(qtypes int8[K, n1r], qtab uint8[K, n1r, n1r], qdmat
    f32[K, n1r, n1r], n1s int32[K]) for K queries padded to n1r, uploaded
    in one copy (views of one byte buffer, 256-byte aligned)."""
    qts, qtabs, qdmats = [], [], []
    for q in queries:
        qtypes, qtabp, qdmat = prepare_query(q, n1r)
        qts.append(qtypes.astype(np.int8))
        qtabs.append(qtabp.astype(np.uint8))
        qdmats.append(qdmat)
    parts = (np.stack(qts), np.stack(qtabs), np.stack(qdmats),
             np.array([q.order for q in queries], np.int32))
    if not on_bf16_grid(parts[2]):
        raise ValueError("query distances are not on the bf16 grid "
                         "(pack queries with io/pack.pack_query)")
    offsets = np.cumsum([0] + [-(-p.nbytes // 256) * 256 for p in parts])
    buf = np.zeros(int(offsets[-1]), np.uint8)
    for p, o in zip(parts, offsets):
        buf[o:o + p.nbytes] = p.reshape(-1).view(np.uint8)
    dbuf = torch.from_numpy(buf).to(device)
    return tuple(
        dbuf[o:o + p.nbytes].view(getattr(torch, str(p.dtype))).view(p.shape)
        for p, o in zip(parts, offsets))


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
                try:
                    parts.append(fn(*(x[t] for x in q), plan, seed=seed,
                                    tags=tags[t], c_par=c_par, r_seq=r_seq,
                                    lorder=lorder, lsoln=lsoln,
                                    params=params))
                finally:
                    trace.end(tsp)
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
