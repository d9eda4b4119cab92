"""ROC / AUC evaluation.

Copy of cuda_satabsearch_tpu/eval/roc.py (that package imports jax).

Reimplements the reference's evaluation semantics
(scripts/tsevalutils.py:44-66 trapezoid AUC; scripts/mkroc50tab.py
ROC50) with vectorized numpy: scores + binary gold-standard labels in,
ROC curve / AUC / ROC50 out.  Ties are handled by treating equal-score
results as one threshold step (the same curve the reference's
sort-based sweep produces when traversed per distinct cutoff).
"""

from __future__ import annotations

import numpy as np


def compute_auc(fpr, tpr) -> float:
    """Trapezoid area under an ROC curve (tsevalutils.py:44-66)."""
    fpr = np.asarray(fpr, dtype=np.float64)
    tpr = np.asarray(tpr, dtype=np.float64)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_curve(scores, labels) -> tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) sweeping the score threshold from high to low.

    scores: higher = better hit.  labels: 1 for gold-standard positive.
    Returns curves that start at (0,0) and end at (1,1), with one point
    per distinct score value.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    l = labels[order]
    npos = int(l.sum())
    nneg = len(l) - npos
    if npos == 0 or nneg == 0:
        raise ValueError("need at least one positive and one negative")
    tp = np.cumsum(l)
    fp = np.cumsum(~l)
    # collapse ties: keep the last index of each distinct score
    distinct = np.r_[s[1:] != s[:-1], True]
    tpr = np.r_[0.0, tp[distinct] / npos]
    fpr = np.r_[0.0, fp[distinct] / nneg]
    return fpr, tpr


def auc(scores, labels) -> float:
    """Full ROC AUC for scores vs binary labels."""
    fpr, tpr = roc_curve(scores, labels)
    return compute_auc(fpr, tpr)


def roc_n(scores, labels, n: int = 50) -> float:
    """ROC-N score: area up to the N-th false positive, normalized by
    n*npos (the CASP/BLAST 'ROC50' metric used by mkroc50tab.py).

    TIE-FAIR: raw SA scores are small integers, so tied blocks are the
    norm; within a block of p positives and q negatives the TP count
    credited to each negative is interpolated linearly across the
    block (the same convention roc_curve's tie collapse embodies).  A
    per-row sweep instead inherits the arbitrary input (DB file) order
    of tied entries and is irreproducible across orderings."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores)
    s = scores[order]
    l = labels[order]
    npos = int(l.sum())
    if npos == 0:
        raise ValueError("need at least one positive")
    tp = 0
    fp = 0
    area = 0.0
    i = 0
    while i < len(s) and fp < n:
        j = i
        while j < len(s) and s[j] == s[i]:
            j += 1
        p = int(l[i:j].sum())
        q = (j - i) - p
        if q:
            k = min(q, n - fp)
            # TP while crossing the block rises linearly tp -> tp + p;
            # negative m of q sits at fraction (m - 0.5) / q
            area += k * tp + p * (k * k) / (2.0 * q)
            fp += k
        tp += p
        i = j
    if fp < n:  # fewer than n negatives: count remaining at full tp
        area += (n - fp) * tp
    return area / float(n * npos)
