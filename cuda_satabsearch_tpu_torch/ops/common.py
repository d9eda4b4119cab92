"""Shared layout helpers for the SA search (numpy only).

Counterpart of cuda_satabsearch_tpu/ops/common.py:18-58: the query-side
padding quantum, the uniform slot schedule and the query packing shared
by the plain engine (ops/engine.py), the CUDA kernel (ops/sa_kernel.py)
and the bucket dispatch (ops/kernel_search.py).
"""

from __future__ import annotations

import numpy as np

from ..core.codes import TYPE_PAD
from ..core.constants import DEFAULTS

C_MAX = 128  # most chains per (entry, query): one CUDA thread each


def round8(x: int) -> int:
    """Query-order padding quantum.  Also keys the RNG slot schedule:
    per restart, slots [0, round8(n1)) feed thinit and slots
    round8(n1) + 3*it + {0,1,2} feed iteration it, so any query order in
    the same round8 group shares one stream layout (mixed-order query
    batching)."""
    return max(8, -(-x // 8) * 8)


def slots_per_restart(n1: int, maxiter: int = DEFAULTS.maxiter) -> int:
    """Uniform slots consumed per restart under the n1r schedule."""
    return round8(n1) + 3 * maxiter


def pack_tab(tabhi: np.ndarray, tablo: np.ndarray) -> np.ndarray:
    """Pack hi/lo tableau planes into hi*8 + lo as float32."""
    return (tabhi.astype(np.float32) * 8.0
            + tablo.astype(np.float32)).astype(np.float32)


def prepare_query(query, n1r: int):
    """(qtypes_i32[n1r], qtabp_f32[n1r, n1r] (hi*8 + lo), qdmat_f32)
    padded to n1r; padded type rows get an impossible type."""
    n1 = query.order
    qtypes = np.full((n1r,), TYPE_PAD, np.int32)
    qtypes[:n1] = query.types
    qtabp = np.zeros((n1r, n1r), np.float32)
    qtabp[:n1, :n1] = pack_tab(query.tabhi, query.tablo)
    qdmat = np.zeros((n1r, n1r), np.float32)
    qdmat[:n1, :n1] = query.dmat
    return qtypes, qtabp, qdmat
