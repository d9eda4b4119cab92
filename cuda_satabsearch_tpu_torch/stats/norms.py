"""Size normalizations and empirical z-scores for match scores.

Copy of cuda_satabsearch_tpu/stats/norms.py (that package imports jax).

Reimplements scripts/norms.py (norm1/norm2/norm3, the Pelta et al 2008
MAX-CMO normalizations applied to tableau match scores) and the
empirical z-score of scripts/tszscore.py, vectorized.
"""

from __future__ import annotations

import numpy as np


def norm1(score, size1, size2):
    """score / min(sizes) (norms.py:33-49)."""
    score = np.asarray(score, dtype=np.float64)
    return score / np.minimum(np.asarray(size1, np.float64),
                              np.asarray(size2, np.float64))


def norm2(score, size1, size2):
    """2*score / (size1 + size2) (norms.py:57-74; the search CLI's
    default normalization, same as stats.gumbel.norm2)."""
    score = np.asarray(score, dtype=np.float64)
    return 2.0 * score / (np.asarray(size1, np.float64)
                          + np.asarray(size2, np.float64))


def norm3(score, size1, size2):
    """norm1, zeroed when the SSE-count difference exceeds 75%
    (norms.py:77-96)."""
    size1 = np.asarray(size1, np.float64)
    size2 = np.asarray(size2, np.float64)
    frac = np.abs(size1 - size2) / np.maximum(size1, size2)
    return np.where(frac > 0.75, 0.0, norm1(score, size1, size2))


def empirical_zscores(scores):
    """Z-scores against the sample's own mean/std (tszscore.py)."""
    s = np.asarray(scores, dtype=np.float64)
    sd = s.std()
    if sd == 0:
        return np.zeros_like(s)
    return (s - s.mean()) / sd
