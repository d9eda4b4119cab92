"""COPS benchmark gold-standard handling.

Copy of cuda_satabsearch_tpu/eval/cops.py (that package imports jax).

The COPS benchmark (Frank et al. 2010, Bioinformatics 26(4):574-575;
benchmark.services.came.sbg.ac.at) distributes a true-positives file:
one whitespace-delimited line per query — the query id followed by its
(exactly 6) true positives.  The reference parses it in
scripts/rocrcops.py:parse_cops_tp_file (:59-87) and scores each query's
search results against those positives.

The data files themselves are not bundled with the reference (its
rocrcops.py points at a private directory); this module converts a
user-supplied COPS true-positives file into the eval CLI's generic
gold-standard mapping, so COPS evaluation is
``python -m cuda_satabsearch_tpu_torch.eval results.out --cops-tp cops.truepositives``.
"""

from __future__ import annotations


def parse_cops_tp(path: str, strict: bool = False) -> dict[str, set[str]]:
    """{query id (lower): set of true-positive ids (lower)}.

    Lines with fewer than 7 fields (query + 6 TPs) are warned about and
    skipped, as in rocrcops.py:81-84; ``strict`` raises instead.
    """
    import sys

    gold: dict[str, set[str]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            if len(parts) < 7:
                msg = f"bad line in COPS tp file: {line.rstrip()}"
                if strict:
                    raise ValueError(msg)
                print(f"WARNING: {msg}", file=sys.stderr)
                continue
            gold[parts[0].lower()] = {p.lower() for p in parts[1:]}
    return gold
