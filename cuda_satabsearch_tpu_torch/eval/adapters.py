"""Competitor-output adapters: normalize other structure-search tools'
native output to the 2-column ``dbid score`` format the eval layer
consumes, so every method is scored by the exact same AUC machinery.

Copy of cuda_satabsearch_tpu/eval/adapters.py (that package imports
jax), with one repair: ``split_multiquery`` drops an LSOLN pair line
only inside an LSOLN block, as ``results.iter_multiquery`` does.

Functional twins of the reference's ``scripts/*out2col*`` family:

  dalilite      DaliLite .dccp            daliliteout2col.py
  vast          VAST .gibbs               vastout2col.py
  ssm           SSM webserver XML         ssmxmlout2col.py
  tableausearch TableauComparer scores    tableausearchout2col.py
  sheba         SHEBA -A summary          shebaout2col.sh
  yakusa        YAKUSA default output     yakusaout2col.sh
  topscompare   tops_comparison output    topscompareout2col.sh
  lock2         LOCK2 (FoldMiner) output  lock2out2col.sh

plus ``split_multiquery`` (multi2colout2single.py): split a multiquery
2-col stream into one file per query.

Each adapter is a generator ``(fh) -> yields ('#'-comment | (dbid,
score))`` — scores stay strings to preserve the source tool's own
formatting, exactly like the reference's awk/py pipelines.  CLI:

    python -m cuda_satabsearch_tpu_torch.eval.adapters FORMAT [-q] < native.out
    python -m cuda_satabsearch_tpu_torch.eval.adapters split OUTDIR < multi.out
"""

from __future__ import annotations

import os
import re
import sys
from itertools import groupby
from typing import Iterator, TextIO

from .fischer import FISCHER_ID_FOLD

Item = "str | tuple[str, str]"


def _dedup_max(scorelist: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """One (id, score) per id, keeping the max score — both DaliLite and
    VAST emit multiple records per target (daliliteout2col.py:79-86).

    NOTE: max() is over the score STRINGS — lexicographic, so e.g.
    '9.5' > '30.0'.  This deliberately reproduces the reference
    daliliteout2col.py/vastout2col.py quirk (Python 2 max over string
    scores) so converted columns match the reference's byte-for-byte;
    it can keep the numerically smaller record when duplicate scores
    cross a digit-count boundary."""
    out = []
    for tid, grp in groupby(sorted(scorelist), lambda t: t[0]):
        out.append((tid, max(s for _t, s in grp)))
    return out


def dali_to_fischer_id(daliid: str) -> str:
    """DaliLite id with trailing chain (``1atnA``) -> Fischer-set id
    (``1atn_a``; ids the Fischer set lists chainless stay chainless,
    daliliteout2col.py:36-52)."""
    pdbid = daliid[:4].lower()
    if pdbid in FISCHER_ID_FOLD:
        return pdbid
    return pdbid + "_" + daliid[4:5].lower()


def iter_dalilite(fh: TextIO, fischer_ids: bool = True) -> Iterator:
    """DaliLite .dccp records -> (target, Z-score); max-Z per target.
    DCCP lines carry the target in field 10 (or 9 when fields 2-3 run
    together, daliliteout2col.py:66-77)."""
    query = None
    scorelist = []
    for line in fh:
        parts = line.split()
        if parts and parts[0] == "DCCP":
            if len(parts) == 10:
                target, z, q = parts[9], parts[5], parts[8]
            else:
                target, z, q = parts[8], parts[4], parts[7]
            if query is None:
                query = q
            scorelist.append((target, z))
    conv = dali_to_fischer_id if fischer_ids else (lambda s: s)
    if query is not None:
        yield f"# QUERY ID = {conv(query)}"
    for target, z in _dedup_max(scorelist):
        yield conv(target), z


def iter_vast(fh: TextIO) -> Iterator:
    """VAST .gibbs output -> (target, Pcli); max per target
    (vastout2col.py:31-44: the score row follows the 'Nres ... Pcli'
    header row of each 'Nclique=' block)."""
    scorelist = []
    dbid = None
    value_header = False
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        if len(parts) > 1 and parts[1] == "Nclique=":
            dbid = parts[0]
            value_header = False
        elif parts[0] == "Nres" and len(parts) > 6 and parts[6] == "Pcli":
            value_header = True
        elif value_header:
            scorelist.append((dbid, parts[6]))
            value_header = False
    yield from _dedup_max(scorelist)


def iter_ssm_xml(fh: TextIO) -> Iterator:
    """SSM webserver XML -> (target name, Q-score) per <Match>
    (ssmxmlout2col.py:31-47)."""
    from xml.dom import minidom

    doc = minidom.parse(fh)
    for match in doc.getElementsByTagName("Match"):
        def child(node, name):
            return [c for c in node.childNodes
                    if c.nodeType == c.ELEMENT_NODE
                    and c.nodeName == name][0]
        qval = child(match, "Q-score").firstChild.data.strip()
        sid = child(child(match, "Target"), "name").firstChild.data.strip()
        yield sid, qval


def iter_tableausearch(fh: TextIO) -> Iterator:
    """TableauComparer search.scores: '<path>.ent.angles
    Score-of-comparison: <s>' -> (basename sans 2 extensions, score)
    (tableausearchout2col.py:28-33)."""
    for line in fh:
        parts = line.split()
        if len(parts) < 2:
            continue
        base = os.path.basename(parts[0])
        base = os.path.splitext(os.path.splitext(base)[0])[0]
        yield base, parts[-1]


def iter_sheba(fh: TextIO) -> Iterator:
    """SHEBA -A summary table -> (pdb2, m); the table runs from its
    ' pdb1   na       pdb2 ...' header to the next blank line
    (shebaout2col.sh:30)."""
    in_table = False
    rows = []
    for line in fh:
        if re.search(r"pdb1\s+na\s+pdb2\s+nb\s+id\s+m\s", line):
            in_table = True
            continue
        if in_table:
            if not line.strip():
                break
            rows.append(line.split())
    if rows:
        yield f"# QUERYID = {rows[0][0]}"
    for parts in rows:  # head -n -1: the last row is uncondition-
        # ally dropped (footer), even when it is the only row —
        # matching shebaout2col.sh's unconditional `head -n -1`
        if parts is not rows[-1]:
            yield parts[2], parts[5]


def iter_yakusa(fh: TextIO, queryid: bool = False) -> Iterator:
    """YAKUSA 'Protein rank:' lines -> (name, Z-score); 'inf' -> 99999
    (yakusaout2col.sh:41-50)."""
    for line in fh:
        if line.startswith("Protein rank:"):
            parts = line.split()
            score = parts[6]
            if score == "inf":
                score = "99999"
            yield parts[8], score
        elif line.startswith("Description query :") and queryid:
            yield f"# QUERY ID = {line.split()[6]}"
        elif line.startswith(("Query: ", "Database: ")):
            yield f"# {line.rstrip()}"


def iter_topscompare(fh: TextIO) -> Iterator:
    """tops_comparison '<score> <id>' rows (skipping the 'probe' row) ->
    (id[:7], score) (topscompareout2col.sh:21)."""
    for line in fh:
        parts = line.split()
        if len(parts) >= 2 and parts[1] != "probe":
            yield parts[1][:7], parts[0]


def iter_lock2(fh: TextIO, queryid: bool = False) -> Iterator:
    """LOCK2 (FoldMiner) '** Target = <path>' / 'final score: <s>'
    pairs -> (basename[:7], score) (lock2out2col.sh:42-59)."""
    target = None
    done_query = False
    for line in fh:
        if line.startswith("** Target ="):
            target = os.path.basename(line.split()[3])[:7]
        elif line.startswith("final score:"):
            yield target, line.split()[2]
        elif line.startswith("** Query =") and queryid and not done_query:
            yield f"# QUERY ID = {os.path.basename(line.split()[3])[:7]}"
            done_query = True


ADAPTERS = {
    "dalilite": iter_dalilite,
    "vast": iter_vast,
    "ssm": iter_ssm_xml,
    "tableausearch": iter_tableausearch,
    "sheba": iter_sheba,
    "yakusa": iter_yakusa,
    "topscompare": iter_topscompare,
    "lock2": iter_lock2,
}


def write_2col(items, out: TextIO) -> None:
    for item in items:
        if isinstance(item, str):
            out.write(item + "\n")
        else:
            out.write(f"{item[0]}    {item[1]}\n")


def split_multiquery(fh: TextIO, outdir: str) -> list[str]:
    """Split a multiquery 2-col stream (delimited by '# QUERY ID ='
    lines) into one '<qid>.out' per query in ``outdir``; queries are
    merged across repeated headers (the small-db/large-db two-pass
    output, multi2colout2single.py:84-99).  Returns paths written."""
    from .results import iter_result_rows

    # row-level split (NOT iter_multiquery): scores must stay the
    # source tool's own STRINGS, byte-for-byte — a float round trip
    # would rewrite '25.10' as '25.1' (module contract above)
    merged: dict[str, list] = {}
    for qid, parts in iter_result_rows(fh):
        if qid is None:
            continue
        rows = merged.setdefault(qid.lower(), [])
        if parts is None or len(parts) < 2:
            continue
        try:
            float(parts[1])
        except ValueError:
            continue
        rows.append((parts[0], parts[1]))
    paths = []
    for qid, results in sorted(merged.items()):
        if not results:
            continue
        path = os.path.join(outdir, qid + ".out")
        with open(path, "w") as out:
            for dbid, score_str in results:
                out.write(f"{dbid}    {score_str}\n")
        paths.append(path)
    return paths


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="torchsatabsearch-adapters",
        description="competitor output -> 2-column 'dbid score'")
    ap.add_argument("format", choices=sorted(ADAPTERS) + ["split"])
    ap.add_argument("outdir", nargs="?", default=None,
                    help="output directory (split mode only)")
    ap.add_argument("-q", "--queryid", action="store_true",
                    help="emit a '# QUERY ID =' header (yakusa/lock2)")
    ap.add_argument("--no-fischer-ids", action="store_true",
                    help="dalilite: keep raw ids instead of Fischer form")
    args = ap.parse_args(argv)

    if args.format == "split":
        if not args.outdir:
            ap.error("split mode requires OUTDIR")
        os.makedirs(args.outdir, exist_ok=True)
        for p in split_multiquery(sys.stdin, args.outdir):
            print(p, file=sys.stderr)
        return 0

    fn = ADAPTERS[args.format]
    if args.format in ("yakusa", "lock2"):
        items = fn(sys.stdin, queryid=args.queryid)
    elif args.format == "dalilite":
        items = fn(sys.stdin, fischer_ids=not args.no_fischer_ids)
    else:
        items = fn(sys.stdin)
    write_2col(items, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
