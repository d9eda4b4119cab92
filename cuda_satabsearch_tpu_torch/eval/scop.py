"""SCOP classification utilities (Bio.SCOP-free).

Copy of cuda_satabsearch_tpu/eval/scop.py (that package imports jax).

The reference's SCOP-based evaluation layer (scripts/tsevalfn.py,
scopdominfo.py, fastscopdominfo.py, getdomainsinsf.py, genquerylist.py)
depends on a local SCOP installation read through Bio.SCOP.  Here the
same capabilities are built on the standard SCOP(e) *classification
file* (``dir.cla.scop.txt`` / ``dir.cla.scope.txt``), which every SCOP
release ships:

    sid  pdbid  chain:range  sccs  sunid  cl=..,cf=..,sf=..,fa=..,...

``sccs`` strings like ``b.1.1.1`` encode class.fold.superfamily.family;
grouping sids by a prefix of it yields the fold/superfamily/family gold
standards that tsevalfn.py builds from Bio.SCOP hierarchy walks
(tsevalutils.py:618-800), and class-proportional query sampling
reproduces genquerylist.py.
"""

from __future__ import annotations

from dataclasses import dataclass


LEVEL_PARTS = {"class": 1, "fold": 2, "superfamily": 3, "family": 4}


@dataclass(frozen=True)
class ScopDomain:
    sid: str       # e.g. d1ubia_
    pdbid: str     # e.g. 1ubi
    region: str    # e.g. 'A:' or 'A:1-76'
    sccs: str      # e.g. d.15.1.1
    sunid: int


def parse_cla(path_or_fp) -> list[ScopDomain]:
    """Parse a SCOP dir.cla file ('#' comments skipped)."""
    fh = open(path_or_fp) if isinstance(path_or_fp, str) else path_or_fp
    try:
        out = []
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            if len(parts) < 5:
                continue
            out.append(ScopDomain(sid=parts[0], pdbid=parts[1],
                                  region=parts[2], sccs=parts[3],
                                  sunid=int(parts[4])))
        return out
    finally:
        if isinstance(path_or_fp, str):
            fh.close()


def sccs_prefix(sccs: str, level: str) -> str:
    """'b.1.1.1' at level 'fold' -> 'b.1'."""
    n = LEVEL_PARTS[level]
    return ".".join(sccs.split(".")[:n])


def group_by_level(domains, level: str = "fold") -> dict[str, list[str]]:
    """{group key: [sids]} at class/fold/superfamily/family level."""
    out: dict[str, list[str]] = {}
    for d in domains:
        out.setdefault(sccs_prefix(d.sccs, level), []).append(d.sid)
    return out


def scop_gold(domains, queries=None, level: str = "fold",
              restrict_to=None) -> dict[str, set[str]]:
    """Gold standard {query sid: positive sids} — positives are every
    domain sharing the query's group at ``level`` (tsevalfn.py
    semantics).  ``restrict_to``: optional iterable of sids actually in
    the searched DB (positives outside it are dropped).
    """
    by_sid = {d.sid: d for d in domains}
    groups = group_by_level(domains, level)
    allowed = None if restrict_to is None else {s.lower()
                                                for s in restrict_to}
    qs = list(queries) if queries is not None else sorted(by_sid)
    gold: dict[str, set[str]] = {}
    for q in qs:
        d = by_sid.get(q) or by_sid.get(q.lower())
        if d is None:
            continue
        pos = set(groups[sccs_prefix(d.sccs, level)])
        if allowed is not None:
            pos = {p for p in pos if p.lower() in allowed}
        gold[d.sid] = pos
    return gold


def domain_info(domains, sids) -> list[str]:
    """scopdominfo.py equivalent: one 'sid sccs fold-key sf-key' line
    per requested sid (unknown sids reported as comments)."""
    by_sid = {d.sid.lower(): d for d in domains}
    lines = []
    for s in sids:
        d = by_sid.get(s.lower())
        if d is None:
            lines.append(f"# {s}: not in classification")
        else:
            lines.append(f"{d.sid} {d.sccs} "
                         f"{sccs_prefix(d.sccs, 'fold')} "
                         f"{sccs_prefix(d.sccs, 'superfamily')}")
    return lines


def parse_des(path_or_fp) -> dict:
    """{(level, sccs): description} from a SCOP dir.des file.

    dir.des lines are 'sunid level sccs sid description...'
    (level in cl/cf/sf/fa/dm/sp/px; sid is '-' above domain level).
    """
    fh = open(path_or_fp) if isinstance(path_or_fp, str) else path_or_fp
    try:
        out = {}
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split(None, 4)
            if len(parts) < 5:
                continue
            out[(parts[1], parts[2])] = parts[4].strip()
        return out
    finally:
        if isinstance(path_or_fp, str):
            fh.close()


def dominfo_dict(domains, des: dict | None = None) -> dict:
    """{sid: (sf_sccs, sf_desc, fold_sccs, fold_desc)} — the content of
    the reference's pickled scopdominfo cache
    (build_fastscopdominfo_cache.py, consumed by ssemap2html.py),
    built from dir.cla (+ optional dir.des descriptions)."""
    des = des or {}
    out = {}
    for d in domains:
        sf = sccs_prefix(d.sccs, "superfamily")
        fold = sccs_prefix(d.sccs, "fold")
        out[d.sid] = (sf, des.get(("sf", sf), ""),
                      fold, des.get(("cf", fold), ""))
    return out


def sample_query_list(domains, n: int, seed: int = 1,
                      available=None) -> list[str]:
    """genquerylist.py equivalent: sample ``n`` sids with class
    proportions matching the classification (true classes a-g), without
    replacement, deterministically from ``seed``."""
    import numpy as np

    avail = None if available is None else {s.lower() for s in available}
    by_class: dict[str, list[str]] = {}
    for d in domains:
        if avail is not None and d.sid.lower() not in avail:
            continue
        c = d.sccs.split(".")[0]
        if c in "abcdefg":
            by_class.setdefault(c, []).append(d.sid)
    total = sum(len(v) for v in by_class.values())
    if total == 0:
        return []
    n = min(n, total)
    rng = np.random.default_rng(seed)
    picks: list[str] = []
    # largest-remainder apportionment of n over classes
    quotas = {c: n * len(v) / total for c, v in by_class.items()}
    counts = {c: int(q) for c, q in quotas.items()}
    rem = n - sum(counts.values())
    for c in sorted(quotas, key=lambda c: quotas[c] - counts[c],
                    reverse=True)[:rem]:
        counts[c] += 1
    for c in sorted(by_class):
        pool = sorted(by_class[c])
        k = min(counts.get(c, 0), len(pool))
        idx = rng.choice(len(pool), size=k, replace=False)
        picks.extend(pool[i] for i in sorted(idx))
    return picks


def db_headers(dbfile: str) -> tuple[list[tuple[str, str]], int]:
    """([(name, order_str)], dotted_skips) — the ASCII DB header scan
    shared by _db_names and eval.tables.timer_table.

    A header is "name order": second token an int.  Distance rows can
    never collide (they are %6.3f pairs — the second token always
    carries a decimal point, so int() rejects it); the only guard
    needed on the NAME is excluding a literal float (a '.'), NOT
    float()-parseability — names like '1e50' or '2e28' are real PDB
    ids that float() would wrongly swallow."""
    headers = []
    dotted = 0
    with open(dbfile) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 2:
                continue
            try:
                int(parts[1])
            except ValueError:
                continue
            if "." not in parts[0]:
                headers.append((parts[0], parts[1]))
            else:
                dotted += 1
    return headers, dotted


def _db_names(dbfile: str) -> list[str]:
    """Entry names of an ASCII DB (header lines are 'name order')."""
    import sys
    headers, dotted = db_headers(dbfile)
    if dotted:
        # SCOP sids never contain dots, but an unexpected id scheme
        # should be visible, not silently excluded from sampling
        print(f"# _db_names: skipped {dotted} dotted candidate header "
              f"name(s) in {dbfile} (names containing '.' are treated "
              f"as distance rows)", file=sys.stderr)
    return [n for n, _o in headers]


def main(argv=None) -> int:
    """SCOP metadata CLI — the driver surface of tsevalfn.py /
    scopdominfo.py / genquerylist.py: produce gold-standard files,
    domain info lines, or class-proportional query lists from a SCOP(e)
    dir.cla classification file."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.eval.scop",
        description="SCOP gold-standard / metadata utilities "
                    "(dir.cla-based)")
    ap.add_argument("--cla", required=True,
                    help="SCOP(e) dir.cla classification file")
    ap.add_argument("--make-gold", default=None,
                    choices=sorted(LEVEL_PARTS),
                    help="emit a gold-standard file ('qid pos1 pos2 ...' "
                         "lines) at this level, consumable by "
                         "python -m cuda_satabsearch_tpu_torch.eval --gold")
    ap.add_argument("--queries", default=None,
                    help="file of query sids (one per line; default: "
                         "every classified sid)")
    ap.add_argument("--restrict-db", default=None,
                    help="ASCII DB file; positives not present in it "
                         "are dropped (tsevalutils 'filter to db')")
    ap.add_argument("--dominfo", nargs="*", default=None,
                    help="print 'sid sccs fold sf' lines for these sids "
                         "(scopdominfo.py equivalent)")
    ap.add_argument("--sample-queries", type=int, default=None,
                    metavar="N",
                    help="print N class-proportional query sids "
                         "(genquerylist.py equivalent)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    domains = parse_cla(args.cla)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.dominfo is not None:
            for line in domain_info(domains, args.dominfo):
                out.write(line + "\n")
        elif args.sample_queries is not None:
            avail = None
            if args.restrict_db:
                avail = _db_names(args.restrict_db)
            for sid in sample_query_list(domains, args.sample_queries,
                                         seed=args.seed, available=avail):
                out.write(sid + "\n")
        elif args.make_gold:
            queries = None
            if args.queries:
                with open(args.queries) as fh:
                    queries = [ln.strip() for ln in fh if ln.strip()]
            restrict = (_db_names(args.restrict_db)
                        if args.restrict_db else None)
            gold = scop_gold(domains, queries=queries,
                             level=args.make_gold, restrict_to=restrict)
            for qid in sorted(gold):
                out.write(" ".join([qid] + sorted(gold[qid])) + "\n")
        else:
            ap.error("one of --make-gold / --dominfo / --sample-queries "
                     "is required")
    finally:
        if args.output:
            out.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
