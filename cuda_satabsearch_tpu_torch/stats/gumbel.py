"""Score normalization and Gumbel statistics.

Reimplements the reference's nvcc_src_current/gumbelstats.c:50-94.
Copy of cuda_satabsearch_tpu/stats/gumbel.py (that package imports jax),
with a span around ``score_stats`` (trace.py).

The reference declares ``z_gumbel(int x, ...)`` but every call site
passes the *double* norm2 score (cudaSaTabsearch.cu:1105-1106), which C
silently truncates toward zero -- quantizing z-scores and p-values into
a few discrete levels (visible in README_example_usage.txt:43-49 where
many entries share z = -1.27278).  We compute the continuous z-score by
default and reproduce the truncation behind ``compat=True`` for
byte-level output parity with the reference.
"""

from __future__ import annotations

import math

import numpy as np

from .. import trace
from ..core.constants import GUMBEL_A, GUMBEL_B

EULER_GAMMA = 0.5772156649015328606
PI_OVER_SQRT6 = math.pi / math.sqrt(6.0)


def norm2(score, size1, size2):
    """Size normalization: 2*score / (n1 + n2) (gumbelstats.c:91-94)."""
    return 2.0 * np.asarray(score, dtype=np.float64) / (
        np.asarray(size1, dtype=np.float64) + np.asarray(size2, np.float64))


def z_gumbel(x, a: float = GUMBEL_A, b: float = GUMBEL_B, *,
             compat: bool = False):
    """Z-score under Gumbel(a, b) (gumbelstats.c:50-58).

    compat=True truncates x toward zero first, matching the reference's
    int-parameter call sites.
    """
    x = np.asarray(x, dtype=np.float64)
    if compat:
        x = np.trunc(x)
    mu = a + b * EULER_GAMMA
    sigma = PI_OVER_SQRT6 * b
    return (x - mu) / sigma


def pv_gumbel(z):
    """P-value for a Gumbel z-score (gumbelstats.c:69-72)."""
    z = np.asarray(z, dtype=np.float64)
    return 1.0 - np.exp(-np.exp(-(PI_OVER_SQRT6 * z + EULER_GAMMA)))


def score_stats(score, qn, dbn, *, a: float = GUMBEL_A, b: float = GUMBEL_B,
                compat: bool = False):
    """(norm2, z, p) triple for a raw score, as printed per result line
    (cudaSaTabsearch.cu:1102-1114)."""
    sp = trace.begin("stats.score_stats")
    try:
        n2s = norm2(score, qn, dbn)
        z = z_gumbel(n2s, a, b, compat=compat)
        p = pv_gumbel(z)
        return n2s, z, p
    finally:
        trace.end(sp)
