"""Method-comparison table utilities: StAR interchange, timing tables.

Copy of cuda_satabsearch_tpu/eval/tables.py (that package imports jax).

Consolidates the reference's small table-generation scripts:

* ``slrtabs_to_star`` — scripts/slrtabs2star.py:73-141: per-method
  .slrtab files -> the positives.dat / negatives.dat inputs of StAR
  (Vergara et al. 2008), tab-delimited with method names on line 1;
* ``parse_star_results`` / ``parse_star_conf_intervals`` /
  ``star_auc_table`` — scripts/star2auctable.py: StAR's results.txt
  (delta-AUC upper triangle, p-value lower triangle) +
  conf_intervals.txt -> per-method significance rows vs a reference
  method;
* ``timer_table`` — scripts/mktimertab.py: '-t' timing output (query,
  score, cputime) + the query .input files -> an R read.table frame
  'queryid dbid querysses dbsses score cputime';
* ``sum_elapsed`` — scripts/sumtimes.sh: sum the `time(1)` "elapsed"
  stamps ([H:]M:SS[.cc]) across a set of .err log files.

All plain-text transforms (no device code); the CLI main() mirrors the
script surfaces.
"""

from __future__ import annotations

import re
import sys
from typing import TextIO


def iter_slrtab(fh: TextIO):
    """(score, label) pairs from a .slrtab 'score 0|1' stream."""
    for line in fh:
        parts = line.split()
        if len(parts) >= 2:
            yield float(parts[0]), int(parts[1])


def slrtabs_to_star(listing, posfile: str, negfile: str,
                    log=None) -> None:
    """Write StAR positives/negatives files from per-method slrtabs.

    ``listing``: iterable of (method_name, slrtab_path) — the
    reference reads these as TAB-delimited stdin lines.  Methods may
    have different score counts; rows are emitted up to the LONGEST
    method with empty cells beyond a method's scores (the reference
    indexed every list by the first method's length and crashed on
    mismatch — its own FIXME at slrtabs2star.py:122)."""
    names, pos, neg = [], [], []
    for name, path in listing:
        with open(path) as fh:
            sl = list(iter_slrtab(fh))
        names.append(name)
        pos.append([s for s, l in sl if l == 1])
        neg.append([s for s, l in sl if l == 0])
        if log:
            log(f"{name}: {len(sl)} entries ({len(pos[-1])} pos, "
                f"{len(neg[-1])} neg)")

    def emit(path, cols):
        with open(path, "w") as fh:
            fh.write("\t".join(names) + "\n")
            for i in range(max((len(c) for c in cols), default=0)):
                fh.write("\t".join(
                    str(c[i]) if i < len(c) else "" for c in cols)
                    + "\n")

    emit(posfile, pos)
    emit(negfile, neg)


def parse_star_results(fh: TextIO):
    """(matrix, methods) from StAR results.txt: delta-AUC in the upper
    triangle, p-values in the lower (star2auctable.py:44-79)."""
    import numpy as np

    methods = None
    mat = None
    i = 0
    for line in fh:
        cells = line.rstrip("\n").split("\t")
        if len(cells) < 2:
            continue
        if line[0] == "\t":
            methods = [c.strip().strip('"') for c in cells[1:]]
            mat = np.zeros((len(methods), len(methods)))
            i = 0
            continue
        for j, v in enumerate(cells[1:]):
            if i != j and v.strip():
                mat[i, j] = float(v)
        i += 1
    return mat, methods


def parse_star_conf_intervals(fh: TextIO) -> dict:
    """{(m1, m2): (signed_delta_auc, ci_lo, ci_hi)} from StAR
    conf_intervals.txt (star2auctable.py:83-117; first line is the
    header)."""
    out = {}
    for ln, line in enumerate(fh):
        if ln == 0:
            continue
        cells = line.rstrip("\n").split("\t")
        if len(cells) < 3:
            continue
        m1, m2 = (m.strip().strip('"') for m in cells[0].split("/"))
        delta = float(cells[1])
        ci = cells[2].replace("(", " ").replace(")", " ") \
            .replace(",", " ").split()
        out[(m1, m2)] = (delta, float(ci[0]), float(ci[1]))
    return out


def star_auc_table(results_fh: TextIO, ci_fh: TextIO, reference: str,
                   sigp: float = 0.05) -> list[str]:
    """Significance rows vs a reference method
    (star2auctable.py:130-205): 'method  |dAUC|  p  signed_dAUC' for
    each method whose AUC differs significantly, then one pooled row
    for the methods that do not."""
    mat, methods = parse_star_results(results_fh)
    ci = parse_star_conf_intervals(ci_fh)
    if reference not in methods:
        raise ValueError(f"method {reference!r} not in {methods}")
    j = methods.index(reference)

    rows = []
    notdiff = []
    for i, m in enumerate(methods):
        if m == reference:
            continue
        try:
            signed = ci[(reference, m)][0]
        except KeyError:
            signed = -ci[(m, reference)][0]
        if i < j:
            dauc, p = mat[i, j], mat[j, i]
        else:
            p, dauc = mat[i, j], mat[j, i]
        if p < sigp:
            rows.append(f"{m}\t{dauc:5.4f}\t{p:5.4g}\t{signed:5.4f}")
        else:
            notdiff.append(m)
    if notdiff:
        rows.append("%s\t%4.3f\t%5.4g\t%4.3f" % (
            ", ".join([reference] + notdiff), 0, sigp, 0))
    return rows


def timer_table(fh: TextIO, input_dir: str, out: TextIO,
                dbfile: str | None = None) -> None:
    """'-t' timing output -> 'queryid dbid querysses dbsses score
    cputime' R table (mktimertab.py semantics; ``input_dir`` holds the
    <queryid>.input files instead of the reference's hardcoded
    $HOME/phd path; ``dbfile`` overrides the stream's DBFILE header)."""
    import os

    queryid = None
    querysses = "?"
    db_named = dbfile
    dbsses: dict | None = None
    wrote_header = False
    for line in fh:
        if line.startswith("# QUERY ID ="):
            out.write("# " + line)
            queryid = line.split("=", 1)[1].strip().lower()
            inp = os.path.join(input_dir, queryid + ".input")
            querysses = "?"
            if os.path.isfile(inp):
                with open(inp) as ifh:
                    for il in ifh:
                        if il[:len(queryid)].lower() == queryid:
                            querysses = il.split()[1]
                            break
        elif line.startswith("# DBFILE ="):
            out.write("# " + line)
            if dbfile is None:
                db_named = line.split("=", 1)[1].strip()
        elif line.startswith("#") or not line.strip():
            out.write("# " + line)
        else:
            if not wrote_header:
                out.write("queryid dbid querysses dbsses score "
                          "cputime\n")
                wrote_header = True
                dbsses = {}
                if db_named and os.path.isfile(db_named):
                    from .scop import db_headers

                    dbsses = dict(db_headers(db_named)[0])
            parts = line.split()
            dbid, score, cputime = parts[0], parts[1], parts[2]
            out.write(f"{queryid} {dbid} {querysses} "
                      f"{dbsses.get(dbid, '?')} {score} {cputime}\n")


def star_auc_latex(rows: list[str], include_p: bool = True
                   ) -> list[str]:
    """star2auctable rows -> the LaTeX tabular of starauctable2tex.sh
    (sorted ascending by signed delta-AUC, its GNU `sort -k4,4n`;
    p-value column optional via -n)."""
    out = [r"{\begin{tabular}{lrr}  \hline" if include_p
           else r"{\begin{tabular}{lr}  \hline"]
    out.append(r"Method(s) & $\Delta\mathrm{AUC}$"
               + (r" & p-value \\" if include_p else r" \\"))
    out.append(r"\hline")
    for row in sorted(rows, key=lambda r: float(r.split("\t")[3])):
        c = row.split("\t")
        if include_p:
            out.append(f"{c[0]:<40s} & {c[3]} & {c[2]} \\\\")
        else:
            out.append(f"{c[0]:<40s} & {c[3]}  \\\\")
    out.append(r"\hline")
    out.append(r"\end{tabular}}")
    return out


def merge_output(dir1: str, dir2: str, out: TextIO) -> None:
    """Join two result directories of 2-col '<qid>.out' files into
    'queryid dbid score1 score2' rows (mergeoutput.sh:40-56: inner
    join on dbid per query, '#' comments and ERROR lines dropped) —
    the large-scale method-vs-method score comparison input."""
    import glob
    import os

    def load(path):
        d = {}
        with open(path) as fh:
            for line in fh:
                if line.startswith("#") or "ERROR" in line:
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    d[parts[0]] = parts[1]
        return d

    for qpfile in sorted(glob.glob(os.path.join(dir1, "*.out"))):
        qid = os.path.basename(qpfile)[:-4]
        other = os.path.join(dir2, qid + ".out")
        if not os.path.isfile(other):
            continue
        s1, s2 = load(qpfile), load(other)
        for dbid in sorted(set(s1) & set(s2)):
            out.write(f"{qid} {dbid} {s1[dbid]} {s2[dbid]}\n")


def result_rank(fh: TextIO, target: str) -> tuple[int, int]:
    """(rank, total) of ``target`` among a result file's hits sorted
    ascending by score (getrank.sh: its `sort -k2,2n | grep -n`
    convention — rank 1 is the WORST score; '#' comments skipped)."""
    rows = []
    for line in fh:
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 2:
            try:
                rows.append((float(parts[1]), parts[0]))
            except ValueError:
                continue
    rows.sort(key=lambda r: r[0])
    for i, (_s, name) in enumerate(rows, 1):
        if target.lower() in name.lower():
            return i, len(rows)
    raise ValueError(f"{target} not found among {len(rows)} results")


_ELAPSED_RE = re.compile(
    r"(?:(\d+):)?(\d+):(\d+(?:\.\d+)?)\s*elapsed")


def sum_elapsed(texts, fmt: str = "hms") -> str:
    """Sum `time(1)` elapsed stamps across log texts (sumtimes.sh):
    takes the LAST '[H:]MM:SS[.cc]elapsed' stamp of each text.  fmt:
    'hms' (default), 'ms' (-m: minutes+seconds), 'hm' (-h)."""
    total = 0.0
    for text in texts:
        last = None
        for m in _ELAPSED_RE.finditer(text):
            last = m
        if last is None:
            continue
        h = int(last.group(1) or 0)
        total += h * 3600 + int(last.group(2)) * 60 + float(
            last.group(3))
    secs = int(total + 0.5)  # half-up, not banker's
    h, rem = divmod(secs, 3600)
    mnt, s = divmod(rem, 60)
    if fmt == "ms":
        return f"{h * 60 + mnt} m {s} s"
    if fmt == "hm":
        return f"{h} h {mnt + (1 if s >= 30 else 0)} m"
    return f"{h} h {mnt} m {s} s"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.eval.tables",
        description="method-comparison table utilities (slrtabs2star/"
                    "star2auctable/mktimertab/sumtimes twins)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("star", help="slrtabs -> StAR pos/neg files; "
                        "TAB-delimited 'name<TAB>path' lines on stdin")
    p1.add_argument("posfile")
    p1.add_argument("negfile")
    p1.add_argument("-v", action="store_true")

    p2 = sub.add_parser("auctable", help="StAR outputs -> significance "
                        "rows vs a reference method")
    p2.add_argument("results")
    p2.add_argument("conf_intervals")
    p2.add_argument("reference")
    p2.add_argument("-p", type=float, default=0.05)
    p2.add_argument("--latex", action="store_true",
                    help="emit the starauctable2tex.sh LaTeX tabular")
    p2.add_argument("-n", dest="nop", action="store_true",
                    help="omit the p-value column (LaTeX mode)")

    p5 = sub.add_parser("merge", help="join two result dirs of "
                        "<qid>.out files into 'qid dbid s1 s2' rows")
    p5.add_argument("dir1")
    p5.add_argument("dir2")

    p6 = sub.add_parser("rank", help="rank of a target id in a result "
                        "file (getrank.sh)")
    p6.add_argument("target")
    p6.add_argument("resultsfile")

    p3 = sub.add_parser("timertab", help="'-t' timing output (stdin) "
                        "-> R table")
    p3.add_argument("--input-dir", required=True)
    p3.add_argument("--dbfile", default=None)

    p4 = sub.add_parser("sumtimes", help="sum time(1) elapsed stamps "
                        "over .err files")
    p4.add_argument("files", nargs="+")
    p4.add_argument("-m", dest="fmt", action="store_const",
                    const="ms", default="hms")
    p4.add_argument("-H", dest="fmt", action="store_const", const="hm")

    args = ap.parse_args(argv)
    if args.cmd == "star":
        listing = [tuple(line.rstrip("\n").split("\t", 1))
                   for line in sys.stdin if line.strip()]
        slrtabs_to_star(
            listing, args.posfile, args.negfile,
            log=(lambda m: print(m, file=sys.stderr)) if args.v
            else None)
    elif args.cmd == "auctable":
        with open(args.results) as rfh, \
                open(args.conf_intervals) as cfh:
            rows = star_auc_table(rfh, cfh, args.reference, args.p)
        if args.latex:
            rows = star_auc_latex(rows, include_p=not args.nop)
        for row in rows:
            print(row)
    elif args.cmd == "merge":
        merge_output(args.dir1, args.dir2, sys.stdout)
    elif args.cmd == "rank":
        with open(args.resultsfile) as fh:
            rank, total = result_rank(fh, args.target)
        print(f"{rank}/{total} ({100.0 * rank / total:.0f}%)")
    elif args.cmd == "timertab":
        timer_table(sys.stdin, args.input_dir, sys.stdout,
                    dbfile=args.dbfile)
    elif args.cmd == "sumtimes":
        texts = []
        for f in args.files:
            with open(f) as fh:
                texts.append(fh.read())
        print(sum_elapsed(texts, args.fmt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
