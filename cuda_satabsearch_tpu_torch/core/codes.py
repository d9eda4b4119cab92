"""Tableau-code and SSE-type encodings.

The ASCII formats use two-character tableau codes (orientation classes)
and two-character SSE type codes.  We encode them as small integers; the
pair-score function only ever tests *equality* of the two halves, so we
keep the halves as separate planes (``hi``/``lo``) rather than packing
nibbles into one byte as the reference does
(the reference's nvcc_src_current/parsetableaux.c:14-34).  The packed
DB keeps the separate planes of cuda_satabsearch_tpu/core/codes.py, of
which this module is a copy (that package imports jax); the CUDA kernel
re-packs them as hi*8 + lo at upload (ops/search.upload_db).

Encoding (same value assignments as the reference so that packed DBs are
interconvertible):

  first char  : P=0 R=1 O=2 L=3 ?=4
  second char : E=0 D=1 S=2 T=3 ?=4

  SSE types   : e (strand)=0, xa (alpha helix)=1, xi (pi helix)=2,
                xg (3_10 helix)=3
"""

from __future__ import annotations

import numpy as np

TAB_HI = {"P": 0, "R": 1, "O": 2, "L": 3, "?": 4}
TAB_LO = {"E": 0, "D": 1, "S": 2, "T": 3, "?": 4}
TAB_HI_INV = {v: k for k, v in TAB_HI.items()}
TAB_LO_INV = {v: k for k, v in TAB_LO.items()}

SSE_CODES = {"e": 0, "xa": 1, "xi": 2, "xg": 3}
SSE_CODES_INV = {v: k for k, v in SSE_CODES.items()}

# Padding sentinel for SSE-type vectors: must never equal a real type.
TYPE_PAD = 127


def encode_tabcode(code: str) -> tuple[int, int]:
    """Two-char tableau code -> (hi, lo) ints (parsetableaux.c:88-140)."""
    c = code.strip()
    if len(c) != 2 or c[0] not in TAB_HI or c[1] not in TAB_LO:
        raise ValueError(f"invalid tableau code {code!r}")
    return TAB_HI[c[0]], TAB_LO[c[1]]


def encode_ssetype(code: str) -> int:
    """Two-char SSE type code -> int (parsetableaux.c:52-76)."""
    c = code.strip()
    if c not in SSE_CODES:
        raise ValueError(f"bad SSE type {code!r}")
    return SSE_CODES[c]


def decode_tabcode(hi: int, lo: int) -> str:
    return TAB_HI_INV[int(hi)] + TAB_LO_INV[int(lo)]


def decode_ssetype(t: int) -> str:
    return SSE_CODES_INV[int(t)]


def tscord(xhi: int, xlo: int, yhi: int, ylo: int) -> int:
    """Discrete tableau pair score: 2 if both halves equal, 1 if exactly
    one half equal, else -2 (cudaSaTabsearch_kernel.cu:306-332)."""
    he = xhi == yhi
    le = xlo == ylo
    if he and le:
        return 2
    if he or le:
        return 1
    return -2


def tscord_np(xhi, xlo, yhi, ylo):
    """Vectorized numpy tscord."""
    he = np.equal(xhi, yhi)
    le = np.equal(xlo, ylo)
    return np.where(he & le, 2, np.where(he | le, 1, -2)).astype(np.int32)
