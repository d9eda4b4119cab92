"""Spans inside the search path, read after the fact.

A span is one pass through a layer boundary of the search path
(``session.resolve_query``, ``session.search``, ``session.search_many``,
``kernel_search.launch_group``, ``kernel_search.enqueue``,
``kernel_search.drain``, ``stats.score_stats``).  It records its name,
its start and end in nanoseconds of ``time.time_ns``, its parent (the
span open when it began) and a request id: a span opened with no parent
takes a new request id, and its children inherit it.  ``time.time_ns``
is the Unix clock on which ``torch.profiler`` gives its CUDA records, so
a span and the device activity it caused can be lined up.

Spans are recorded while a ``torch.profiler`` profile runs, and inside
``recording()``, but not inside ``paused()`` (the capture of a CUDA
graph, which launches nothing: its replays record); otherwise a boundary
costs a function call and two attribute reads, with no clock read and
no allocation.  They are kept
in memory, in the order they end, up to ``BOUND`` spans; a span past
the bound is counted in ``dropped()``.  Recording adds no
synchronisation, event or copy on the device.  One thread records.

Each ``kernel_search.drain`` span carries, in ``nbytes``, the bytes of
scores and maps that the drain brought to the host.  Each
``kernel_search.enqueue`` span names the query tile it launched, its
queries K in ``queries`` and their padded order in ``n1r``, and carries
the figures of the SA launches it made (ops/kernel_search.launch_figures):
``ctas``, the CTAs of their grids, K x the plan's columns x S;
``cta_slots``, for each launch the card's SMs times the CTAs of its
launch class resident on one SM, summed (0 off a card); and
``chain_moves``, maxiter x r_seq / S, the dependent moves of a chain in
one CTA (S the launches' restart split, ops/sa_kernel.restart_split).

    sp = trace.begin("session.search", tag, nqueries)
    try:
        ...
    finally:
        trace.end(sp)
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

BOUND = 1 << 20  # spans kept in memory
# (ctas, cta_slots, chain_moves, n1r): no SA launches
NO_FIGURES = (0, 0, 0, 0)

# the span names of the search path, from the entry point down
SPANS = ("session.resolve_query", "session.search", "session.search_many",
         "kernel_search.launch_group", "kernel_search.enqueue",
         "kernel_search.drain", "stats.score_stats")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    sid: int  # this span's id, in the order spans begin
    parent: int  # sid of the span open when this one began; -1: none
    request: int
    tag: int  # the first query tag of a search span; -1: none
    queries: int  # queries of a search span; 0: none
    nbytes: int  # bytes brought to the host (kernel_search.drain); else 0
    # the SA launches of a kernel_search.enqueue span; else 0
    ctas: int = 0  # CTAs in their grids
    cta_slots: int = 0  # SMs x resident CTAs per SM of each, summed
    chain_moves: int = 0  # maxiter x r_seq / S: a chain's moves in one CTA
    n1r: int = 0  # the padded order of the tile's queries


class _Recorder:
    def __init__(self):
        self.forced = 0  # depth of recording() blocks
        self.paused = 0  # depth of paused() blocks
        # closed spans as plain tuples, which the collector need not track:
        # (name, start_ns, sid, parent, request, tag, queries, end_ns, nbytes,
        # ctas, cta_slots, chain_moves, n1r)
        self.closed: list[tuple] = []
        self.dropped = 0
        self.stack: list[tuple] = []  # the open spans' tokens
        self.next_sid = 0
        self.next_request = 0


_rec = _Recorder()


def begin(name: str, tag: int = -1, queries: int = 0):
    """Open a span; None, at no further cost, when not recording."""
    if not (_profiler._is_profiler_enabled or _rec.forced) or _rec.paused:
        return None
    r = _rec
    sid = r.next_sid
    r.next_sid = sid + 1
    if r.stack:
        top = r.stack[-1]
        parent, request = top[2], top[4]
    else:
        parent, request = -1, r.next_request
        r.next_request = request + 1
    token = (name, time.time_ns(), sid, parent, request, tag, queries)
    r.stack.append(token)
    return token


def end(token, nbytes: int = 0, figures: tuple = NO_FIGURES) -> None:
    """Close the span ``begin`` returned (a no-op for None), with its
    ``nbytes`` and its launch ``figures`` (ctas, cta_slots, chain_moves,
    n1r)."""
    if token is None:
        return
    t = time.time_ns()
    r = _rec
    r.stack.pop()
    if len(r.closed) < BOUND:
        r.closed.append(token + (t, nbytes, *figures))
    else:
        r.dropped += 1


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    _rec.forced += 1
    try:
        yield
    finally:
        _rec.forced -= 1


@contextlib.contextmanager
def paused():
    """Record no span inside the block, even while recording."""
    _rec.paused += 1
    try:
        yield
    finally:
        _rec.paused -= 1


def spans() -> list[Span]:
    """The spans recorded so far, in the order they ended."""
    return [Span(name, start, end, sid, parent, request, tag, queries,
                 *rest)
            for name, start, sid, parent, request, tag, queries, end, *rest
            in _rec.closed]


def dropped() -> int:
    """Spans not kept because the buffer held ``BOUND``."""
    return _rec.dropped


def clear() -> None:
    """Forget the recorded spans and the count of dropped ones."""
    _rec.closed.clear()
    _rec.dropped = 0
