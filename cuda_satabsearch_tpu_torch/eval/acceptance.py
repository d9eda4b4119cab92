"""Ranking-parity acceptance metrics against reference outputs.

Copy of cuda_satabsearch_tpu/eval/acceptance.py (that package imports jax).

The reference's acceptance methodology is statistical: per-entry raw
scores differ between its own CPU and GPU runs (different RNG streams;
README_example_usage.txt:43-49 vs :92-98), so correctness is judged on
score *rankings* and benchmark statistics, not bitwise values
(SURVEY §4).  This module quantifies ranking agreement between a run
of this framework and a reference-oracle run of the SAME query/DB:

* Spearman rank correlation over all entries;
* top-k overlap (|top_k(a) ∩ top_k(b)| / k);
* retrieval AUC: gold standard = the reference run's top q-fraction,
  candidate ranking = our scores (and, for the noise floor, the
  reference's own second RNG stream).

The acceptance bar mirrors BASELINE.md's "AUC within 1% of the
reference CPU path": our AUC against ref-CPU gold must be within 0.01
of the reference GPU's AUC against the same gold (the GPU-vs-CPU
agreement IS the reference's own reproducibility floor, measured from
the archived logs old/nvcc_src_cuda5/*.o14624*).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .roc import auc


def scores_by_name(result_lines) -> dict[str, float]:
    """{name: score} from parsed (score, name) pairs (last wins)."""
    return {name: score for score, name in result_lines}


def _common(a: dict, b: dict):
    names = sorted(set(a) & set(b))
    if not names:
        raise ValueError("no common entries between result sets")
    return (np.array([a[n] for n in names]),
            np.array([b[n] for n in names]), names)


def spearman(a: dict[str, float], b: dict[str, float]) -> float:
    """Spearman rank correlation over the common entries (average
    ranks for ties — scores are small ints, ties are the norm)."""
    va, vb, _ = _common(a, b)

    def rank(x):
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x))
        r[order] = np.arange(len(x), dtype=float)
        # average tied ranks
        for v in np.unique(x):
            m = x == v
            r[m] = r[m].mean()
        return r

    ra, rb = rank(va), rank(vb)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def topk_overlap(a: dict[str, float], b: dict[str, float], k: int) -> float:
    va, vb, names = _common(a, b)
    ta = {names[i] for i in np.argsort(-va, kind="stable")[:k]}
    tb = {names[i] for i in np.argsort(-vb, kind="stable")[:k]}
    return len(ta & tb) / k


def retrieval_auc(candidate: dict[str, float], gold_ref: dict[str, float],
                  q: float = 0.05) -> float:
    """AUC of ``candidate`` scores retrieving the top q-fraction of
    ``gold_ref`` (rank-based gold cut, ties broken stably)."""
    vg, vc, names = _common(gold_ref, candidate)
    k = max(1, int(round(q * len(names))))
    gold_idx = np.argsort(-vg, kind="stable")[:k]
    labels = np.zeros(len(names), dtype=bool)
    labels[gold_idx] = True
    return auc(vc, labels)


@dataclass
class ParityReport:
    spearman: float
    top10: float
    top50: float
    auc5: float  # retrieval AUC, gold = ref top 5%

    def row(self) -> str:
        return (f"spearman={self.spearman:.4f} top10={self.top10:.2f} "
                f"top50={self.top50:.2f} auc5={self.auc5:.4f}")


def parity_report(candidate: dict[str, float],
                  reference: dict[str, float]) -> ParityReport:
    return ParityReport(
        spearman=spearman(candidate, reference),
        top10=topk_overlap(candidate, reference, 10),
        top50=topk_overlap(candidate, reference, 50),
        auc5=retrieval_auc(candidate, reference),
    )
