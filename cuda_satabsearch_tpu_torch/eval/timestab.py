"""Method-comparison LaTeX table: AUC, total time, speedup.

Copy of cuda_satabsearch_tpu/eval/timestab.py (that package imports jax).

The equivalent of the reference's mkquery200timestab.sh (:28-73): one
row per method/run — mean ROC AUC over the query set, total wall time,
and speedup relative to the first (baseline) row — sorted by time
descending, emitted as a LaTeX tabular.

Input is a TSV manifest (comments with '#'):

    label<TAB>results_file<TAB>seconds

where ``results_file`` is a multiquery search output (the reference's
format; '-' column conventions as in eval/__main__) and ``seconds`` the
run's total wall time (the reference sums per-query .err timings with
sumtimes.sh; here runs record their own total).  AUC is computed per
query against the chosen gold standard and averaged.

Usage:
    python -m cuda_satabsearch_tpu_torch.eval.timestab manifest.tsv \
        (--gold FILE | --fischer fold|class | --nh3d arch|class)
"""

from __future__ import annotations

import argparse
import sys

from .results import iter_multiquery
from .roc import auc


def hms(seconds: float) -> str:
    s = int(round(seconds))
    return f"{s // 3600} h {(s % 3600) // 60} m {s % 60} s"


def mean_auc(results_path: str, gold: dict, negate: bool = False) -> float:
    total, nq = 0.0, 0
    with open(results_path) as fh:
        for qid, results in iter_multiquery(fh, skip_self=True):
            pos = gold.get(qid.lower())
            if pos is None:
                continue
            scores = [-s if negate else s for s, _ in results]
            labels = [1 if n.lower() in pos else 0 for _, n in results]
            npos = sum(labels)
            if npos == 0 or npos == len(labels):
                continue
            total += auc(scores, labels)
            nq += 1
    if nq == 0:
        raise ValueError(f"no evaluable queries in {results_path}")
    return total / nq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchsatabsearch-timestab",
        description="LaTeX AUC/time/speedup method table "
                    "(mkquery200timestab.sh equivalent)")
    ap.add_argument("manifest", help="TSV: label, results file, seconds")
    ap.add_argument("--gold", default=None)
    ap.add_argument("--fischer", default=None, choices=["fold", "class"])
    ap.add_argument("--nh3d", default=None, choices=["arch", "class"])
    ap.add_argument("--negate", action="store_true",
                    help="negate scores (lower = better input)")
    args = ap.parse_args(argv)

    sources = [s for s in (args.gold, args.fischer, args.nh3d) if s]
    if len(sources) != 1:
        ap.error("exactly one of --gold / --fischer / --nh3d is required")
    if args.fischer:
        from .fischer import fischer_gold
        gold = fischer_gold(args.fischer)
    elif args.nh3d:
        from .nh3d import nh3d_gold
        gold = nh3d_gold(args.nh3d)
    else:
        from .__main__ import load_gold_standard
        gold = load_gold_standard(args.gold)

    rows = []
    baseline_s = None
    with open(args.manifest) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 3:
                print(f"WARNING: bad manifest line: {line.rstrip()}",
                      file=sys.stderr)
                continue
            label, path, secs = parts
            secs = float(secs)
            if baseline_s is None:
                baseline_s = secs
            rows.append((label, mean_auc(path, gold, args.negate), secs,
                         baseline_s / secs))

    print(r"\begin{tabular}{lrrr}")
    print(r"\hline")
    print(r"Method & AUC & time & speedup \\")
    print(r"\hline")
    for label, a, secs, speedup in sorted(rows, key=lambda r: -r[2]):
        print(f"{label:<22s} & {a:5.2f} & {hms(secs)} & {speedup:8.2f} "
              r"\\")
    print(r"\hline")
    print(r"\end{tabular}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
