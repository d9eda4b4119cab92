"""ASCII tableaux+distmatrix database/query parsing.

Copy of cuda_satabsearch_tpu/io/parser.py (that package imports jax).

Format (reference: parsetableaux.c:143-294 and cudaSaTabsearch.cu:37-151):

* An entry starts with a header line: identifier (8 chars, right blank
  padded) + space + order (4 digits, left blank padded).
* Then ``order`` lines of the tableau, lower triangle only, one
  two-character code per column at fixed 3-char stride; the diagonal
  holds the SSE type code (e/xa/xi/xg).
* Then ``order`` lines of the SSE distance matrix, lower triangle only,
  F6.3 values at fixed 7-char stride; the diagonal holds the SSE type as
  0.0/1.0/2.0/3.0.
* Entries may be separated by blank lines.

The reference parses at fixed column offsets (buf[j*3] and
strtof(&buf[j*7])); we split on whitespace instead, which is equivalent
for well-formed files and additionally parses rows whose values exceed
the F6.3 field width (present in the bundled multiquery.input fixture,
where distances >= 100 A break the 7-char stride and the reference
silently misparses them).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import Iterator, TextIO

import numpy as np

from ..core import codes
from ..core.constants import MAXDIM


@dataclass
class TableauEntry:
    """One structure: tableau half-planes, SSE types, distance matrix."""

    name: str
    order: int
    tabhi: np.ndarray  # uint8 [n, n], symmetric; diagonal = SSE type
    tablo: np.ndarray  # uint8 [n, n], symmetric; diagonal = SSE type
    types: np.ndarray  # uint8 [n], SSE type codes (the diagonal)
    dmat: np.ndarray  # float32 [n, n], symmetric; diagonal = SSE type


@dataclass
class SearchInput:
    """Parsed stdin payload of the standard (non query-list) mode."""

    dbfile: str
    ltype: bool
    lorder: bool
    lsoln: bool
    queries: list[TableauEntry] = field(default_factory=list)


def _next_nonblank(fp: TextIO) -> str | None:
    for line in fp:
        if line.strip():
            return line
    return None


def _parse_header(line: str) -> tuple[str, int]:
    parts = line.split()
    if len(parts) != 2:
        raise ValueError(f"bad entry header line: {line!r}")
    name, order = parts[0], int(parts[1])
    return name, order


def parse_entry(fp: TextIO, header: str | None = None) -> TableauEntry | None:
    """Parse one entry; returns None at EOF.

    Raises ValueError on malformed input.  Entries of any order are
    parsed (size policy is applied by callers, mirroring
    parsetableaux.c:193-227 which skips order > dim entries).
    """
    if header is None:
        header = _next_nonblank(fp)
        if header is None:
            return None
    name, n = _parse_header(header)

    tabhi = np.zeros((n, n), dtype=np.uint8)
    tablo = np.zeros((n, n), dtype=np.uint8)
    types = np.zeros((n,), dtype=np.uint8)
    dmat = np.zeros((n, n), dtype=np.float32)

    for i in range(n):
        line = fp.readline()
        if not line:
            raise ValueError(f"{name}: EOF inside tableau at row {i}")
        toks = line.split()
        if len(toks) < i + 1:
            raise ValueError(f"{name}: short tableau row {i}: {line!r}")
        for j in range(i + 1):
            code = toks[j]
            if i == j:
                t = codes.encode_ssetype(code)
                types[i] = t
                tabhi[i, i] = t
                tablo[i, i] = t
            else:
                hi, lo = codes.encode_tabcode(code)
                tabhi[i, j] = tabhi[j, i] = hi
                tablo[i, j] = tablo[j, i] = lo

    for i in range(n):
        line = fp.readline()
        if not line:
            raise ValueError(f"{name}: EOF inside distmatrix at row {i}")
        toks = line.split()
        if len(toks) < i + 1:
            raise ValueError(f"{name}: short distmatrix row {i}: {line!r}")
        for j in range(i + 1):
            d = float(toks[j])
            dmat[i, j] = dmat[j, i] = d

    return TableauEntry(name=name, order=n, tabhi=tabhi, tablo=tablo,
                        types=types, dmat=dmat)


def iter_entries(fp: TextIO, maxdim: int = MAXDIM,
                 skipped: list | None = None) -> Iterator[TableauEntry]:
    """Iterate entries, skipping (with a warning) those larger than
    ``maxdim`` (parsetableaux.c:457-465)."""
    import sys

    while True:
        header = _next_nonblank(fp)
        if header is None:
            return
        entry = parse_entry(fp, header)
        if entry.order > maxdim:
            print(f"WARNING: excluded structure {entry.name} as it is "
                  f"too large", file=sys.stderr)
            if skipped is not None:
                skipped.append(entry.name)
            continue
        yield entry


def read_database(path_or_fp, maxdim: int = MAXDIM) -> list[TableauEntry]:
    """Read a whole ASCII database (parsetableaux.c:317-506).

    Unlike the reference we do not split into small/large allocations
    here; size bucketing happens at pack time (io/pack.py).
    """
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, "r") as fp:
            return list(iter_entries(fp, maxdim))
    return list(iter_entries(path_or_fp, maxdim))


def read_queries(fp: TextIO, maxdim: int = MAXDIM) -> list[TableauEntry]:
    """Read query structures from an open stream (parsetableaux.c:522-632)."""
    return list(iter_entries(fp, maxdim))


def parse_search_input(fp: TextIO) -> SearchInput:
    """Parse the standard-mode stdin payload (cudaSaTabsearch.cu:45-151):
    dbfile name line, options line ("T T F" -> LTYPE LORDER LSOLN), then
    query entries."""
    dbline = _next_nonblank(fp)
    if dbline is None:
        raise ValueError("empty input: expected dbfile name")
    dbfile = dbline.split()[0]
    optline = _next_nonblank(fp)
    if optline is None:
        raise ValueError("expected options line 'T|F T|F T|F'")
    parts = optline.split()
    if len(parts) < 3:
        raise ValueError(f"bad options line: {optline!r}")
    ltype, lorder, lsoln = (p.upper() == "T" for p in parts[:3])
    queries = read_queries(fp)
    return SearchInput(dbfile=dbfile, ltype=ltype, lorder=lorder,
                       lsoln=lsoln, queries=queries)


def parse_string(text: str) -> TableauEntry:
    """Convenience: parse a single entry from a string."""
    return parse_entry(_io.StringIO(text))
