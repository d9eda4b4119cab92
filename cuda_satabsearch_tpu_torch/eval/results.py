"""Search-result file parsing and .slrtab emission.

Copy of cuda_satabsearch_tpu/eval/results.py (that package imports
jax), with one repair: a ``%3d %3d`` line is skipped as an LSOLN SSE
pair line only inside an LSOLN block (``iter_result_rows``).  The JAX
package skips every such line, so a real result row like ``123 456``
(an all-digit id with a 3-digit score) is lost from its AUC inputs.

Reimplements the consumer side of the output contract
(scripts/tsevalutils.py:69-130 parse_searchresult, :223-313
iter_searchresult multiquery splitting on '# QUERY ID =' lines;
scripts/mkroctabs.py slrtab emission).
"""

from __future__ import annotations

import re
import sys
from typing import Iterator, TextIO

import numpy as np

_QUERY_RE = re.compile(r"^#\s*QUERY\s?ID\s*=\s*(\S+)", re.IGNORECASE)


def parse_searchresult(fh: TextIO, negate: bool = False, log10: bool = False,
                       sort: bool = True):
    """[(score, domainid)] (+ comment lines), NaN lines skipped
    (tsevalutils.py:69-130).  Sorted ascending when ``sort``."""
    reslist = []
    comments = []
    for line in fh:
        if line.startswith("#"):
            comments.append(line)
            continue
        parts = line.split()
        if len(parts) < 2:
            print(f"bad line: {line.rstrip()}", file=sys.stderr)
            continue
        sid, score_str = parts[0], parts[1]
        if score_str.lower() == "nan" or score_str == "********":
            print(f"skipping NaN: {line.rstrip()}", file=sys.stderr)
            continue
        try:
            score = float(score_str)
        except ValueError:
            print(f"skipping invalid score {line.rstrip()}", file=sys.stderr)
            continue
        if log10:
            score = np.log10(score)
        if negate:
            score = -score
        reslist.append((score, sid))
    if sort:
        reslist.sort()
    return reslist, comments


# the CLI/reference LSOLN pair line format "%3d %3d"
# (cudaSaTabsearch.cu:1110-1113): two right-aligned width-3 ints
_PAIR_LINE = re.compile(
    r"^(?: {2}\d| \d\d|\d{3}) (?: {2}\d| \d\d|\d{3})\s*$")

# fields of the search writer's result row '%-8s %d %g %g %g'
# (cudaSaTabsearch.cu:1102-1114, session.format_results): the only row
# the writer follows with LSOLN pair lines
_SEARCH_ROW_FIELDS = 5


def iter_result_rows(fh: TextIO
                     ) -> Iterator[tuple[str | None, list[str] | None]]:
    """Walk a multiquery stream: ``(qid, None)`` at each '# QUERY ID ='
    line, then ``(qid, fields)`` for each result row under it (``qid``
    is None before the first header).  Comments, blank lines and LSOLN
    pair lines are dropped.

    A '%3d %3d' line is an LSOLN pair line only inside an LSOLN block:
    after a search-result row and its pair lines, before the next result
    row or '# QUERY ID' line, as the writer emits them.  Anywhere else
    it is a result row: an all-digit id and its score."""
    qid = None
    in_block = False
    for line in fh:
        m = _QUERY_RE.match(line)
        if m:
            qid, in_block = m.group(1), False
            yield qid, None
            continue
        if line.startswith("#") or not line.strip():
            continue
        if in_block and _PAIR_LINE.match(line):
            continue
        parts = line.split()
        in_block = len(parts) == _SEARCH_ROW_FIELDS
        yield qid, parts


def iter_multiquery(fh: TextIO, skip_self: bool = False
                    ) -> Iterator[tuple[str, list[tuple[float, str]]]]:
    """Yield (queryid, [(score, domainid)]) per query from a multiquery
    stream delimited by '# QUERY ID =' comment lines
    (tsevalutils.py:223-313; also accepts '# QUERYID =')."""
    qid = None
    results: list[tuple[float, str]] = []
    for q, parts in iter_result_rows(fh):
        if parts is None:
            if qid is not None and results:
                yield qid, results
            qid, results = q, []
            continue
        if len(parts) < 2:
            continue
        sid, score_str = parts[0], parts[1]
        try:
            score = float(score_str)
        except ValueError:
            continue
        if skip_self and qid is not None and sid.lower() == qid.lower():
            continue
        results.append((score, sid))
    if qid is not None and results:
        yield qid, results


def write_slrtab(out: TextIO, results, positives: set[str],
                 lowercase: bool = True) -> None:
    """Emit 'score label' lines for ROCR-style analysis
    (mkroctabs.py slrtab mode): label 1 if the hit is a gold-standard
    positive for the query, else 0."""
    pos = {p.lower() for p in positives} if lowercase else set(positives)
    for score, sid in results:
        key = sid.lower() if lowercase else sid
        out.write(f"{score} {1 if key in pos else 0}\n")
