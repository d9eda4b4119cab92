"""The ASTRAL-like synthetic DB: a frozen copy of its generator.

Copied from cuda_satabsearch_tpu_torch/synthetic.py (``sse_counts``,
``astral_entries``) and io/writer.py (``format_entry``, with the code
tables of core/codes.py) at commit
d4cb1337b7aaf96a99aa4443f325ec93637d3526: an ASTRAL-2.07-like mix of
SSE counts (lognormal, median ~10, clipped to [2, 111]) with random
valid tableaux, sorted by size, written in the reference's ASCII DB
format (``%6s %4d`` header, two-character codes at a 3-character
stride, ``%6.3f`` distances at a 7-character stride).
"""

from __future__ import annotations

import numpy as np

MAXDIM = 111
TAB_HI_INV = {0: "P", 1: "R", 2: "O", 3: "L", 4: "?"}
TAB_LO_INV = {0: "E", 1: "D", 2: "S", 3: "T", 4: "?"}
SSE_CODES_INV = {0: "e", 1: "xa", 2: "xi", 3: "xg"}


def sse_counts(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` SSE counts of the ASTRAL-like mix: lognormal, median ~10,
    clipped to [2, MAXDIM]."""
    return np.clip(rng.lognormal(2.35, 0.55, size=n).astype(int), 2, MAXDIM)


def astral_entries(n: int, seed) -> list[tuple]:
    """An ``n``-entry DB in the ASTRAL-like size mix, sorted by size:
    [(name, order, tabhi, tablo, types, dmat)], the generator's draws in
    its order.  ``seed`` is anything np.random.default_rng takes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, o in enumerate(sorted(sse_counts(rng, n))):
        types = rng.integers(0, 4, size=o).astype(np.uint8)
        hi = np.triu(rng.integers(0, 4, size=(o, o)), 1).astype(np.uint8)
        hi = hi + hi.T
        lo = np.triu(rng.integers(0, 4, size=(o, o)), 1).astype(np.uint8)
        lo = lo + lo.T
        np.fill_diagonal(hi, types)
        np.fill_diagonal(lo, types)
        d = np.triu(rng.random((o, o)) * 30.0, 1).astype(np.float32)
        d = (d + d.T).astype(np.float32)
        np.fill_diagonal(d, types.astype(np.float32))
        out.append((f"syn{i:05d}", int(o), hi, lo, types, d))
    return out


def format_entry(name, order, tabhi, tablo, types, dmat) -> str:
    lines = [f"{name:>6s} {order:>4d}"]
    for i in range(order):
        cells = []
        for j in range(i + 1):
            if i == j:
                cells.append(f"{SSE_CODES_INV[int(types[i])]:<2s} ")
            else:
                code = (TAB_HI_INV[int(tabhi[i, j])]
                        + TAB_LO_INV[int(tablo[i, j])])
                cells.append(f"{code:<2s} ")
        lines.append("".join(cells))
    for i in range(order):
        cells = []
        for j in range(i + 1):
            d = float(types[i]) if i == j else float(dmat[i, j])
            cells.append(f"{d:6.3f} ")
        lines.append("".join(cells))
    return "\n".join(lines) + "\n"


def format_database(entries) -> str:
    """Entries separated by blank lines."""
    return "\n".join(format_entry(*e) for e in entries)
