"""The SA search's operation and byte count, and the least time a card
can take for it: the yardstick of ``sa_roofline``.

The count is a frozen copy of ``sa_bound`` of chip_smoke.py at commit
d4cb1337b7aaf96a99aa4443f325ec93637d3526, re-expressed over the DB's
entry orders instead of a launch plan:

* one threefry2x32 draw is 20 rounds of add, rotate and xor (60), 5 key
  injections (15), 2 initial adds and 3 operations to make the float:
  ``THREEFRY_OPS`` = 80;
* a move is three draws and, per query SSE, ``DELTA_OPS`` = 8 operations
  of the O(n1) delta;
* a restart adds a key, n1 thinit draws and 4 per pair of the initial
  score.

Only real entries count.  Bytes: each entry read once, as its bucket
pads it (type row, the two tableau planes and the float32 distances, 5
bytes per cell, and 8 bytes of order and index), each query once, and
each output (the score, and the map under LSOLN) written once.

The peak (``peaks.json``) is the card's instruction issue rate, 4
warp schedulers x 32 lanes per SM per clock at the maximum SM clock,
and not the 64 INT32 lanes per SM of the original count: the compiler
also issues integer adds and moves to the FMA pipe, so a kernel can run
integer operations faster than the INT32 lanes alone allow, and only
the issue rate bounds every mix of them.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .reference.stream import round8

THREEFRY_OPS = 80
DELTA_OPS = 8
BUCKETS = (8, 16, 24, 32, 48, 64, 80, 112)  # the program's bucket caps
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def restart_ops(n1: int, maxiter: int) -> int:
    return (maxiter * (3 * THREEFRY_OPS + DELTA_OPS * n1)
            + (n1 + 1) * THREEFRY_OPS + 4 * n1 * n1)


def search_ops(n1s, nentries: int, maxstart: int, maxiter: int = 100) -> int:
    """int32 operations of searching queries of orders ``n1s`` against
    ``nentries`` real entries at ``maxstart`` restarts."""
    return nentries * maxstart * sum(restart_ops(int(n1), maxiter)
                                     for n1 in n1s)


def db_bytes(orders) -> int:
    caps = np.asarray(BUCKETS)
    dims = caps[np.searchsorted(caps, np.asarray(orders))]
    return int(np.sum(dims + 5 * dims * dims + 8))


def search_bytes(n1s, orders, lsoln: bool) -> int:
    """Bytes of one pass over the DB for queries of orders ``n1s``."""
    E = len(orders)
    q = sum(round8(n) + 5 * round8(n) ** 2 + 8 for n in n1s)
    out = sum(E * 4 * (1 + (round8(n) if lsoln else 0)) for n in n1s)
    return db_bytes(orders) + q + out


def peak(kind: str) -> dict | None:
    """The card's peaks (peaks.json), or None for a card not listed."""
    with open(PEAKS) as fh:
        return json.load(fh).get(kind)


def bound_s(ops: int, nbytes: int, kind: str) -> float | None:
    """The least seconds the card ``kind`` can take: the larger of the
    operations over its issue rate and the bytes over its memory rate."""
    p = peak(kind)
    if p is None:
        return None
    issue = p["sms"] * p["issue_lanes_per_sm_clock"] * p["max_sm_clock_hz"]
    return max(ops / issue, nbytes / p["hbm_bytes_s"])
