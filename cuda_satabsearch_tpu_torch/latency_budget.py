"""Warm single-query latency budget of a search, from the program's spans.

Counterpart of the JAX package's ``scripts/latency_budget.py``.  Runs
``--reps`` warm queries (586-entry DB, d1ubia_ 8-SSE query): each a
``SearchSession.search`` and the ``score_stats`` of its scores, as the
CLI does, inside ``trace.recording()``.  Prints, per span of the search
path that a query records (``trace.SPANS``, in that order), the median
over the queries of its self time: its duration less its children's.
``session.search``'s own is the glue between launch and drain and the
building of the result; ``kernel_search.launch_group``'s the staging of
the query and its tag and the step's upload, gather and copy-out
(ops/kernel_search.Step); ``kernel_search.enqueue`` the launches;
``kernel_search.drain`` the wait for the device and the copy of the
query's results into arrays of their own.  On a card the queries after
the first two replay a CUDA graph of the same step: there
``launch_group``'s own is the staging and ``enqueue`` the replay.  The
last line is the median of the whole query.

    python -m cuda_satabsearch_tpu_torch.latency_budget [--restarts 128]
        [--reps 7] [--lsoln] [-c]

``-c`` runs the plain engine on the CPU, so that the code can be driven
without a card; its times are the CPU's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import trace
from .io.pack import pack_query
from .io.parser import parse_search_input
from .session import SearchSession, SessionConfig
from .stats.gumbel import score_stats

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures")
DB586 = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
QUERY = os.path.join(FIXTURES, "d1ubia_.input")


def self_ns(spans) -> dict:
    """Self time (ns) by span name over ``spans`` (whole requests), in
    ``trace.SPANS`` order: each span's duration less its children's.
    One thread records, so the children of a span run one after another
    and never overlap: the sum of their durations is their union."""
    name = {s.sid: s.name for s in spans}
    seen = set(name.values())
    own = {k: 0 for k in trace.SPANS if k in seen}
    for s in spans:
        d = s.end_ns - s.start_ns
        own[s.name] += d
        if s.parent in name:
            own[name[s.parent]] -= d
    return own


def budget(restarts: int = 128, reps: int = 7, lsoln: bool = False,
           device=None) -> dict:
    """{"self_ms": {span: median self time per query}, "query_ms": median
    of the whole query (its root spans), "reps", "device"}."""
    with open(QUERY) as fp:
        query = pack_query(parse_search_input(fp).queries[0])
    sess = SearchSession(DB586, SessionConfig(maxstart=restarts,
                                              device=device))

    def one(tag: int):
        r = sess.search(query, lsoln=lsoln, query_tag=tag)
        score_stats(r.scores, query.order, r.orders)

    one(0)  # warm every path involved
    per_query = []
    with trace.recording():
        for i in range(reps):
            before = len(trace.spans())
            one(100 + i)
            per_query.append(trace.spans()[before:])
    med = lambda xs: float(np.median(xs)) / 1e6
    own = [self_ns(spans) for spans in per_query]
    return {"self_ms": {k: med([o[k] for o in own]) for k in own[0]},
            "query_ms": med([sum(s.end_ns - s.start_ns for s in spans
                                 if s.parent == -1) for spans in per_query]),
            "reps": reps, "device": str(sess.device)}


def format_budget(b: dict, restarts: int, lsoln: bool) -> str:
    return "\n".join(
        [f"warm single-query budget on {b['device']} (586-entry DB, 8-SSE "
         f"d1ubia_, r={restarts}, lsoln={lsoln}): median self time of each "
         f"span over {b['reps']} queries"]
        + [f"  {k:<28} {v:.4f} ms" for k, v in b["self_ms"].items()]
        + [f"  {'whole query':<28} {b['query_ms']:.4f} ms"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.latency_budget",
        description="Warm single-query latency budget of a search")
    ap.add_argument("--restarts", type=int, default=128)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--lsoln", action="store_true",
                    help="include SSE maps in the drain (CLI default)")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run the plain engine on the CPU")
    args = ap.parse_args(argv)
    b = budget(args.restarts, args.reps, args.lsoln,
               "cpu" if args.cpu else None)
    print(format_budget(b, args.restarts, args.lsoln))
    return 0


if __name__ == "__main__":
    sys.exit(main())
