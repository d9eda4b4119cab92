"""Reading the ASCII tableaux + distance-matrix database: a frozen copy.

Copied from cuda_satabsearch_tpu_torch/io/parser.py (``parse_entry``),
core/codes.py (the code tables) and io/pack.py (``quantize_dmat``) at
commit d4cb1337b7aaf96a99aa4443f325ec93637d3526.  An entry is a header
line (name, order), ``order`` lines of the tableau's lower triangle
(two-character codes, the diagonal holding the SSE type) and ``order``
lines of the distance matrix's lower triangle.  ``index_file`` finds
every entry's header in one pass over the lines, so that the reference
parses only the entries it compares.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TAB_HI = {"P": 0, "R": 1, "O": 2, "L": 3, "?": 4}
TAB_LO = {"E": 0, "D": 1, "S": 2, "T": 3, "?": 4}
SSE_CODES = {"e": 0, "xa": 1, "xi": 2, "xg": 3}
MAXDIM = 111  # larger entries are skipped on load (saparams.h:15)


@dataclass
class Entry:
    """One structure: tableau half-planes, SSE types, distance matrix
    (float32, rounded to the bf16 grid by ``quantize``)."""

    name: str
    order: int
    tabhi: np.ndarray  # uint8 [n, n]
    tablo: np.ndarray  # uint8 [n, n]
    types: np.ndarray  # uint8 [n]
    dmat: np.ndarray  # float32 [n, n]


@dataclass
class FileIndex:
    """Every loaded entry of a DB file in file order: name, order and the
    line of its header."""

    lines: list[str]
    names: list[str]
    orders: np.ndarray  # int32
    starts: list[int]

    def entry(self, i: int) -> Entry:
        return parse_entry(self.lines, self.starts[i])


def encode_tabcode(code: str) -> tuple[int, int]:
    c = code.strip()
    if len(c) != 2 or c[0] not in TAB_HI or c[1] not in TAB_LO:
        raise ValueError(f"invalid tableau code {code!r}")
    return TAB_HI[c[0]], TAB_LO[c[1]]


def encode_ssetype(code: str) -> int:
    c = code.strip()
    if c not in SSE_CODES:
        raise ValueError(f"bad SSE type {code!r}")
    return SSE_CODES[c]


def quantize(d: np.ndarray) -> np.ndarray:
    """Round float32 distances to the nearest bfloat16 (ties to even),
    kept as float32: the DB's distance grid."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(d, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def parse_entry(lines: list[str], at: int) -> Entry:
    """The entry whose header is ``lines[at]``, distances quantized."""
    parts = lines[at].split()
    if len(parts) != 2:
        raise ValueError(f"bad entry header line: {lines[at]!r}")
    name, n = parts[0], int(parts[1])
    tabhi = np.zeros((n, n), dtype=np.uint8)
    tablo = np.zeros((n, n), dtype=np.uint8)
    types = np.zeros((n,), dtype=np.uint8)
    dmat = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        toks = lines[at + 1 + i].split()
        for j in range(i + 1):
            if i == j:
                t = encode_ssetype(toks[j])
                types[i] = tabhi[i, i] = tablo[i, i] = t
            else:
                hi, lo = encode_tabcode(toks[j])
                tabhi[i, j] = tabhi[j, i] = hi
                tablo[i, j] = tablo[j, i] = lo
    for i in range(n):
        toks = lines[at + 1 + n + i].split()
        for j in range(i + 1):
            dmat[i, j] = dmat[j, i] = float(toks[j])
    return Entry(name=name, order=n, tabhi=tabhi, tablo=tablo, types=types,
                 dmat=quantize(dmat))


def index_file(path: str) -> FileIndex:
    """Index a DB file: each entry's header, skipping blank lines between
    entries and entries larger than MAXDIM (as the loader skips them)."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    names, orders, starts = [], [], []
    at = 0
    while at < len(lines):
        if not lines[at].strip():
            at += 1
            continue
        parts = lines[at].split()
        if len(parts) != 2:
            raise ValueError(f"bad entry header line: {lines[at]!r}")
        n = int(parts[1])
        if n <= MAXDIM:
            names.append(parts[0])
            orders.append(n)
            starts.append(at)
        at += 1 + 2 * n
    return FileIndex(lines=lines, names=names,
                     orders=np.array(orders, np.int32), starts=starts)
