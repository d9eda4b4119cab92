"""Evaluation CLI: multiquery search output -> per-query AUC table.

Copy of cuda_satabsearch_tpu/eval/__main__.py (that package imports
jax).  ``--plot-dir`` needs matplotlib and fails at once, before any
output, where it is not installed.

The functional equivalent of the reference's scripts/mkroctabs.py (and
the AUC core of tsevalfn.py / rocrfischer.py): split a multiquery
result stream on '# QUERY ID =' lines and evaluate each query against a
gold standard, printing an AUC (and optionally ROC50) table, or emit
.slrtab score/label files for external plotting.

The gold standard is a plain text file (one line per query:
``queryid positive1 positive2 ...``), decoupling evaluation from the
reference's Bio.SCOP + SCOP-installation dependency; any classification
(SCOP fold/superfamily/family, Fischer, CATH) reduces to this format.
"""

from __future__ import annotations

import argparse
import os
import sys

from .results import iter_multiquery, write_slrtab
from .roc import auc, roc_n


def load_gold_standard(path: str) -> dict:
    """{queryid_lower: set of positive ids (lower)} from 'qid p1 p2...'
    lines ('#' comments allowed)."""
    gold: dict = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            gold[parts[0].lower()] = {p.lower() for p in parts[1:]}
    return gold


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchsatabsearch-eval",
        description="Per-query ROC AUC from multiquery search output")
    ap.add_argument("results", help="multiquery output file ('-' = stdin)")
    ap.add_argument("--gold", default=None,
                    help="gold-standard file: 'queryid pos1 pos2 ...' lines")
    ap.add_argument("--fischer", default=None, choices=["fold", "class"],
                    help="use the built-in Fischer-1996 gold standard at "
                         "fold or class level (rocrfischer.py equivalent)")
    ap.add_argument("--nh3d", default=None, choices=["arch", "class"],
                    help="use the built-in Nh3D gold standard at CATH "
                         "architecture or class level (rocrnh3d.py "
                         "equivalent; ids in compressed CATH form)")
    ap.add_argument("--cops-tp", default=None, metavar="FILE",
                    help="COPS true-positives file as the gold standard "
                         "(rocrcops.py equivalent)")
    ap.add_argument("--latex", action="store_true",
                    help="emit rows as 'qid & auc \\\\' LaTeX table lines "
                         "(mkauctabrow.sh equivalent)")
    ap.add_argument("--negate", action="store_true",
                    help="negate scores (lower = better input)")
    ap.add_argument("--keep-self", action="store_true",
                    help="keep query-vs-itself hits (dropped by default)")
    ap.add_argument("--roc50", action="store_true",
                    help="also print ROC50")
    ap.add_argument("--slrtab-dir", default=None,
                    help="write per-query .slrtab score/label files here")
    ap.add_argument("--plot-dir", default=None,
                    help="write per-query ROC curve PNGs (+ pooled "
                         "coverage-vs-EPQ plot) here — the reference's "
                         "plotsearchroc.r / fitgumbeldist.r figures")
    args = ap.parse_args(argv)

    sources = [s for s in (args.gold, args.fischer, args.nh3d,
                           args.cops_tp) if s is not None]
    if len(sources) != 1:
        ap.error("exactly one of --gold / --fischer / --nh3d / --cops-tp "
                 "is required")
    if args.fischer:
        from .fischer import fischer_gold
        gold = fischer_gold(args.fischer)
    elif args.nh3d:
        from .nh3d import nh3d_gold
        gold = nh3d_gold(args.nh3d)
    elif args.cops_tp:
        from .cops import parse_cops_tp
        gold = parse_cops_tp(args.cops_tp)
    else:
        gold = load_gold_standard(args.gold)
    fh = sys.stdin if args.results == "-" else open(args.results)
    if args.slrtab_dir:
        os.makedirs(args.slrtab_dir, exist_ok=True)
    if args.plot_dir:
        from .plots import pyplot

        try:
            pyplot()
        except ImportError as e:
            ap.error(f"--plot-dir: {e}")
        os.makedirs(args.plot_dir, exist_ok=True)
    pooled_scores, pooled_labels = [], []

    total_auc, nq = 0.0, 0
    header = "queryid    nhits  npos  auc" + ("    roc50" if args.roc50
                                              else "")
    if not args.latex:
        print(header)
    for qid, results in iter_multiquery(fh, skip_self=not args.keep_self):
        pos = gold.get(qid.lower())
        if pos is None:
            print(f"WARNING: no gold standard for {qid}, skipped",
                  file=sys.stderr)
            continue
        if args.negate:
            results = [(-s, n) for s, n in results]
        scores = [s for s, _ in results]
        labels = [1 if n.lower() in pos else 0 for _, n in results]
        if args.slrtab_dir:
            with open(os.path.join(args.slrtab_dir, f"{qid}.slrtab"),
                      "w") as out:
                write_slrtab(out, results, pos)
        npos = sum(labels)
        if npos == 0 or npos == len(labels):
            print(f"WARNING: degenerate labels for {qid} "
                  f"({npos}/{len(labels)} positive), skipped",
                  file=sys.stderr)
            continue
        if args.plot_dir:
            from .plots import plot_roc
            plot_roc({qid: (scores, labels)},
                     os.path.join(args.plot_dir, f"{qid}_roc.png"),
                     title=qid)
            pooled_scores.extend(scores)
            pooled_labels.extend(labels)
        a = auc(scores, labels)
        if args.latex:
            line = f"{qid} & {a:.4f}"
            if args.roc50:
                line += f" & {roc_n(scores, labels, 50):.4f}"
            line += r" \\"
        else:
            line = f"{qid:<10s} {len(labels):5d} {npos:5d}  {a:.4f}"
            if args.roc50:
                line += f"   {roc_n(scores, labels, 50):.4f}"
        print(line)
        total_auc += a
        nq += 1
    if nq:
        mean = total_auc / nq
        if args.latex:
            print(rf"mean & {mean:.4f} \\")
        else:
            print(f"# mean AUC over {nq} queries: {mean:.4f}")
        if args.plot_dir:
            from .plots import plot_coverage_epq
            plot_coverage_epq(
                {"search": (pooled_scores, pooled_labels, nq)},
                os.path.join(args.plot_dir, "coverage_epq.png"),
                title=f"Coverage vs errors per query ({nq} queries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
