"""Score normalization and Gumbel statistics: a frozen copy.

Copied from cuda_satabsearch_tpu_torch/stats/gumbel.py, with
``GUMBEL_A`` / ``GUMBEL_B`` from core/constants.py, at commit
d4cb1337b7aaf96a99aa4443f325ec93637d3526.  Reimplements the
reference's nvcc_src_current/gumbelstats.c:50-94: norm2 = 2 score /
(n1 + n2), the continuous Gumbel z-score and its p-value.
"""

from __future__ import annotations

import math

import numpy as np

# MLE fit on query200 at 4096 restarts (gumbelstats.h:21-23)
GUMBEL_A = 0.3780327676087335
GUMBEL_B = 0.3582596175507505
EULER_GAMMA = 0.5772156649015328606
PI_OVER_SQRT6 = math.pi / math.sqrt(6.0)


def norm2(score, size1, size2):
    """Size normalization: 2*score / (n1 + n2) (gumbelstats.c:91-94)."""
    return 2.0 * np.asarray(score, dtype=np.float64) / (
        np.asarray(size1, dtype=np.float64) + np.asarray(size2, np.float64))


def z_gumbel(x, a: float = GUMBEL_A, b: float = GUMBEL_B):
    """Z-score under Gumbel(a, b) (gumbelstats.c:50-58)."""
    x = np.asarray(x, dtype=np.float64)
    mu = a + b * EULER_GAMMA
    sigma = PI_OVER_SQRT6 * b
    return (x - mu) / sigma


def pv_gumbel(z):
    """P-value for a Gumbel z-score (gumbelstats.c:69-72)."""
    z = np.asarray(z, dtype=np.float64)
    return 1.0 - np.exp(-np.exp(-(PI_OVER_SQRT6 * z + EULER_GAMMA)))


def score_stats(score, qn, dbn):
    """(norm2, z, p) of raw scores, as printed per result line
    (cudaSaTabsearch.cu:1102-1114)."""
    n2s = norm2(score, qn, dbn)
    z = z_gumbel(n2s)
    return n2s, z, pv_gumbel(z)
