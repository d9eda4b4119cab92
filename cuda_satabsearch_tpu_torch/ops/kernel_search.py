"""Bucket dispatch: resident bucket tensors, one launch per bucket per
round8 query group, results scattered back to file order.

Counterpart of cuda_satabsearch_tpu/ops/pallas_search.py
(``prepare_bucket_pallas2`` :137-194, ``dispatch_db_pallas2[_multi]`` /
``assemble_db_pallas2[_multi]`` :549-717), without the TPU's chunk
plan, entry groups, query scatters and packed int8 drains: each bucket
is uploaded once as plain tensors (whole, or as shards over a mesh of
devices, parallel/mesh.py), K queries of one round8 group run in one
launch per bucket per shard (grid entries x queries), and scores and
maps come back as int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.constants import DEFAULTS, SAParams
from ..parallel.distributed import to_host
from . import rng
from .common import pack_tab, prepare_query, round8
from .engine import search_plain
from .sa_kernel import sa_search


@dataclass
class DeviceBucket:
    """One size bucket resident on a device, in the kernel's format."""

    dim: int  # padded SSE dimension d2
    types: torch.Tensor  # int8 [E, d2]
    tab: torch.Tensor  # uint8 [E, d2, d2], hi*8 + lo
    dmat: torch.Tensor  # float32 [E, d2, d2]
    n2: torch.Tensor  # int32 [E]
    index: np.ndarray  # int32 [E] file-order position, -1 = padding


def prepare_bucket(bucket, device, rows: slice = slice(None)
                   ) -> DeviceBucket:
    """Upload rows ``rows`` of a PackedBucket (from either package's
    packer: the fields and dtypes are the same) once."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x[rows])).to(device)

    return DeviceBucket(
        dim=bucket.dim,
        types=put(bucket.types.astype(np.int8)),
        tab=put(pack_tab(bucket.tabhi, bucket.tablo).astype(np.uint8)),
        dmat=put(bucket.dmat.astype(np.float32)),
        n2=put(bucket.orders.astype(np.int32)),
        index=np.asarray(bucket.index, np.int32)[rows])


def pack_queries(queries, n1r: int, device):
    """(qtypes int8[K, n1r], qtab uint8[K, n1r, n1r], qdmat
    f32[K, n1r, n1r], n1s int32[K]) for K queries padded to n1r."""
    qts, qtabs, qdmats = [], [], []
    for q in queries:
        qtypes, qtabp, qdmat = prepare_query(q, n1r)
        qts.append(qtypes.astype(np.int8))
        qtabs.append(qtabp.astype(np.uint8))
        qdmats.append(qdmat)
    n1s = np.array([q.order for q in queries], np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (
        np.stack(qts), np.stack(qtabs), np.stack(qdmats), n1s))


def search_group(queries, shards: list[list[DeviceBucket]], nentries: int,
                 *, lorder: bool, lsoln: bool, seed: int, query_tags,
                 c_par: int, r_seq: int, backend: str, gather: bool = False,
                 params: SAParams = DEFAULTS):
    """Search K queries of one round8 group against every bucket of
    every shard (ops/search.upload_db).

    ``backend`` "cuda" runs the kernel's wrapper (ops/sa_kernel.py),
    "torch" the plain engine (ops/engine.py), on each shard's device.
    Every shard's buckets are launched, on that device's current stream,
    before any shard is drained, so the devices run together.
    ``gather``: the shards of the other ranks of a multi-process run are
    all-gathered (parallel/distributed.to_host).  Returns
    [(scores int32[nentries], maps int32[nentries, n1] or None)] in
    query order, entries in database file order."""
    n1r = round8(max(q.order for q in queries))
    if any(round8(q.order) != n1r for q in queries):
        raise ValueError("queries of one call must share round8(order)")
    K = len(queries)
    fn = {"cuda": sa_search, "torch": search_plain}[backend]
    launched = []
    for buckets in shards:
        if not buckets:  # an empty DB
            continue
        dev = buckets[0].types.device
        qargs = pack_queries(queries, n1r, dev)
        index = np.concatenate([b.index for b in buckets])
        # every bucket's keys in one call: the threefry rounds are ~200
        # small elementwise ops, whose launches would otherwise repeat
        # per bucket
        keys = rng.entry_keys(seed, query_tags, index, device=dev)
        outs_s, outs_m, off = [], [], 0
        for b in buckets:
            E = len(b.index)
            s, m = fn(*qargs, b.types, b.tab, b.dmat, b.n2,
                      keys=keys[:, off:off + E], c_par=c_par, r_seq=r_seq,
                      lorder=lorder, lsoln=lsoln, params=params)
            off += E
            outs_s.append(s)
            outs_m.append(m)
        launched.append((dev, index, torch.cat(outs_s, dim=1),
                         torch.cat(outs_m, dim=1) if lsoln else None))
    scores = np.zeros((K, nentries), np.int32)
    maps = np.full((K, nentries, n1r), -1, np.int32) if lsoln else None
    for dev, index, s, m in launched:  # one drain per output per shard
        if gather:
            index = to_host(torch.from_numpy(index).to(dev))
            s = to_host(s, dim=1)
            m = to_host(m, dim=1) if lsoln else None
        else:
            s = s.cpu().numpy()
            m = m.cpu().numpy() if lsoln else None
        valid = index >= 0  # drop padding entries
        scores[:, index[valid]] = s[:, valid]
        if lsoln:
            maps[:, index[valid]] = m[:, valid]
    return [(scores[k], None if maps is None else maps[k, :, :q.order])
            for k, q in enumerate(queries)]
