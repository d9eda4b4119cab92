"""Pack parsed entries into padded, size-bucketed dense arrays.

Copy of cuda_satabsearch_tpu/io/pack.py (that package imports jax),
except that ``quantize_dmat`` rounds to bf16 with torch instead of
ml_dtypes.  The packed DB is this system's state: ``PackedDB`` and
``PackedQuery`` keep the JAX package's field names and numpy dtypes, so
a DB packed by either package uploads to the card as it is
(ops/search.upload_db).

Where the reference splits the DB into exactly two size classes driven by
the GPU shared-memory limit (small <= 96 / large <= 111,
cudaSaTabsearch.cu:890-1270), entries here are padded to the smallest
*bucket* cap and a bucket's entries run together; the CUDA kernel sizes
its shared-memory tables by the bucket cap.

Scores are reassembled into original file order via each bucket's
``index`` array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.constants import MAXDIM
from ..core.codes import TYPE_PAD
from .parser import TableauEntry

# Default bucket caps, the JAX package's.  Must be ascending; the last
# must be >= MAXDIM.  ~35-40% of real DB entries (ASTRAL size mix,
# median ~10 SSEs) have <= 8 SSEs; the intermediate caps (24/48/80) cut
# per-entry padding waste for mid-size entries, e.g. the 17-32-SSE
# population (mean ~22) mostly fits in 24.
DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 80, 112)

# Padding value for distance matrices: far beyond MXSSED so a padded lane
# can never contribute score even if a mask were missed.
DMAT_PAD = 1.0e9


@dataclass
class PackedBucket:
    dim: int  # padded SSE dimension of this bucket
    tabhi: np.ndarray  # int8  [N, dim, dim]
    tablo: np.ndarray  # int8  [N, dim, dim]
    types: np.ndarray  # int8  [N, dim], TYPE_PAD beyond each entry's order
    dmat: np.ndarray  # float32 [N, dim, dim], DMAT_PAD beyond order
    orders: np.ndarray  # int32 [N]
    names: list[str]
    index: np.ndarray  # int32 [N]: position of each entry in file order

    @property
    def size(self) -> int:
        return len(self.names)


@dataclass
class PackedDB:
    buckets: list[PackedBucket]
    nentries: int
    names: list[str]  # all names, file order
    orders: np.ndarray  # int32 [nentries], file order

    def lookup(self, name: str) -> tuple[int, int] | None:
        """Case-insensitive name -> (bucket_idx, idx) (mirrors the
        query-list resolution scan, cudaSaTabsearch.cu:746-780)."""
        key = name.lower()
        if not hasattr(self, "_by_name"):
            self._by_name = {}
            for bi, b in enumerate(self.buckets):
                for i, n in enumerate(b.names):
                    if b.index[i] >= 0:
                        self._by_name.setdefault(n.lower(), (bi, i))
        return self._by_name.get(key)

    def entry(self, bucket_idx: int, idx: int) -> TableauEntry:
        """Materialize a packed entry back to a TableauEntry (used when a
        query is resolved from the DB in query-list mode)."""
        b = self.buckets[bucket_idx]
        n = int(b.orders[idx])
        return TableauEntry(
            name=b.names[idx],
            order=n,
            tabhi=np.ascontiguousarray(b.tabhi[idx, :n, :n]).astype(np.uint8),
            tablo=np.ascontiguousarray(b.tablo[idx, :n, :n]).astype(np.uint8),
            types=np.ascontiguousarray(b.types[idx, :n]).astype(np.uint8),
            dmat=np.ascontiguousarray(b.dmat[idx, :n, :n]),
        )


@dataclass
class PackedQuery:
    name: str
    order: int
    tabhi: np.ndarray  # int8  [n, n]
    tablo: np.ndarray  # int8  [n, n]
    types: np.ndarray  # int8  [n]
    dmat: np.ndarray  # float32 [n, n]


def quantize_dmat(d: np.ndarray) -> np.ndarray:
    """Round distances to bfloat16 resolution (stored as float32).

    The packed-DB contract of cuda_satabsearch_tpu/io/pack.py, kept so
    that both packages pack the same DB bit for bit.  torch's float32 ->
    bfloat16 cast rounds to nearest even, the rule ml_dtypes uses there.
    Cost: ~0.4% relative rounding on values whose ASCII source only
    carries ~3 decimals anyway; the only behavioral effect is on
    |d1 - d2| <= MXSSED (4.0 A) decisions within a fraction of an
    Angstrom of the threshold.  SSE-type diagonal codes (0..3) are exact
    in bf16.
    """
    import torch

    t = torch.from_numpy(np.ascontiguousarray(d, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def pack_query(e: TableauEntry) -> PackedQuery:
    return PackedQuery(
        name=e.name,
        order=e.order,
        tabhi=e.tabhi.astype(np.int8),
        tablo=e.tablo.astype(np.int8),
        types=e.types.astype(np.int8),
        dmat=quantize_dmat(e.dmat.astype(np.float32)),
    )


def pack_database(entries: list[TableauEntry],
                  buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                  pad_to: int = 1) -> PackedDB:
    """Pack entries into buckets.

    pad_to: pad each bucket's entry count up to a multiple of this (the
    device-mesh size), so the entry axis can be sharded evenly.  Padding
    entries have order 1, TYPE_PAD types, and index -1 (dropped at
    result-assembly time).
    """
    if buckets != tuple(sorted(buckets)):
        raise ValueError("bucket caps must be ascending")
    if buckets[-1] < MAXDIM:
        raise ValueError(f"last bucket cap must be >= MAXDIM ({MAXDIM})")

    groups: dict[int, list[tuple[int, TableauEntry]]] = {d: [] for d in buckets}
    for pos, e in enumerate(entries):
        for cap in buckets:
            if e.order <= cap:
                groups[cap].append((pos, e))
                break
        else:
            raise ValueError(f"entry {e.name} order {e.order} exceeds max "
                             f"bucket {buckets[-1]}")

    packed: list[PackedBucket] = []
    for cap in buckets:
        grp = groups[cap]
        if not grp:
            continue
        n = -(-len(grp) // pad_to) * pad_to
        tabhi = np.zeros((n, cap, cap), dtype=np.int8)
        tablo = np.zeros((n, cap, cap), dtype=np.int8)
        types = np.full((n, cap), TYPE_PAD, dtype=np.int8)
        dmat = np.full((n, cap, cap), DMAT_PAD, dtype=np.float32)
        orders = np.ones((n,), dtype=np.int32)
        index = np.full((n,), -1, dtype=np.int32)
        names = ["<pad>"] * n
        for i, (pos, e) in enumerate(grp):
            o = e.order
            tabhi[i, :o, :o] = e.tabhi
            tablo[i, :o, :o] = e.tablo
            types[i, :o] = e.types
            dmat[i, :o, :o] = e.dmat
            orders[i] = o
            index[i] = pos
            names[i] = e.name
        dmat = quantize_dmat(dmat)  # whole array incl. padding, so the
        # native (C++) packer path quantizes identically
        packed.append(PackedBucket(dim=cap, tabhi=tabhi, tablo=tablo,
                                   types=types, dmat=dmat, orders=orders,
                                   names=names, index=index))

    return PackedDB(
        buckets=packed,
        nentries=len(entries),
        names=[e.name for e in entries],
        orders=np.array([e.order for e in entries], dtype=np.int32),
    )
