"""Re-emit entries in the ASCII database format.

Copy of cuda_satabsearch_tpu/io/writer.py (that package imports jax).

Byte-compatible with the format produced by the reference toolchain
(scripts/convdb2.py:214-226 / pytableaucreate.py) and consumed by
parsetableaux.c: header ``%6s %4d`` (name right-justified — convdb2's
exact format), tableau lower triangle with 2-char codes at 3-char
stride, distance matrix lower triangle in ``%6.3f`` at 7-char stride,
diagonal carrying SSE types.
"""

from __future__ import annotations

from .parser import TableauEntry
from ..core import codes


def format_entry(e: TableauEntry) -> str:
    lines = [f"{e.name:>6s} {e.order:>4d}"]
    for i in range(e.order):
        cells = []
        for j in range(i + 1):
            if i == j:
                cells.append(f"{codes.decode_ssetype(e.types[i]):<2s} ")
            else:
                cells.append(f"{codes.decode_tabcode(e.tabhi[i, j], e.tablo[i, j]):<2s} ")
        lines.append("".join(cells))
    for i in range(e.order):
        cells = []
        for j in range(i + 1):
            d = float(e.types[i]) if i == j else float(e.dmat[i, j])
            cells.append(f"{d:6.3f} ")
        lines.append("".join(cells))
    return "\n".join(lines) + "\n"


def format_database(entries, sort_by_size: bool = False) -> str:
    """Concatenate entries separated by blank lines; optionally sorted
    ascending by order (convdb2.py -s, which improves load balance of the
    entry-parallel search)."""
    if sort_by_size:
        entries = sorted(entries, key=lambda e: e.order)
    return "\n".join(format_entry(e) for e in entries)
