"""The program's own spans in a traced run, clipped to its window.

The program (cuda_satabsearch_tpu_torch/trace.py) records a span at each
layer boundary of its search path while a torch.profiler profile runs,
on the clock of the profiler's CUDA records (``time.time_ns``).  Per span
name this gives, over the traced window (``run.trace.window_ns``): the
total time, the self time (each span's duration less the union of its
children's intervals), the device's idle time inside the spans, and the
bytes the spans brought to the host.  Each returns None where the run
recorded no spans of the program (the CPU, an untraced run, or a program
that has none) and where the program's bounded buffer dropped spans, so
that a truncated record reads as missing, not low.
"""

from __future__ import annotations

from .trace import overlap_ns, union_ns


def recorded(run):
    """The program's spans that overlap the traced window, or None."""
    t = run.trace
    if t is None or t.window_ns[1] <= t.window_ns[0]:
        return None
    try:
        from cuda_satabsearch_tpu_torch import trace
    except ImportError:
        return None
    if trace.dropped():
        return None
    lo, hi = t.window_ns
    spans = [s for s in trace.spans() if s.end_ns > lo and s.start_ns < hi]
    return spans or None


def merged(intervals) -> list:
    """Sorted disjoint [start, end) pairs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _clipped(run, name: str):
    spans = recorded(run)
    if spans is None:
        return None, None
    lo, hi = run.trace.window_ns
    return [(max(s.start_ns, lo), min(s.end_ns, hi), s) for s in spans
            if s.name == name], spans


def total_ns(run, name: str):
    own, _ = _clipped(run, name)
    return None if own is None else sum(b - a for a, b, _ in own)


def self_ns(run, name: str):
    own, spans = _clipped(run, name)
    if own is None:
        return None
    children: dict[int, list] = {}
    for s in spans:
        children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    return sum((b - a) - union_ns(children.get(s.sid, ()), a, b)
               for a, b, s in own)


def idle_ns(run, name: str):
    """Time inside the spans of ``name`` in which the device ran
    nothing."""
    own, _ = _clipped(run, name)
    if own is None:
        return None
    busy = merged((s, e) for s, e, _ in run.trace.device)
    starts = [s for s, _ in busy]
    return sum(b - a - overlap_ns(busy, starts, a, b)
               for a, b in merged((a, b) for a, b, _ in own))


def nbytes(run, name: str):
    """Bytes the spans of ``name`` that began in the window carry."""
    spans = recorded(run)
    if spans is None:
        return None
    lo = run.trace.window_ns[0]
    return sum(s.nbytes for s in spans if s.name == name
               and s.start_ns >= lo)


def per_query_ms(run, ns):
    if ns is None or not run.window.queries:
        return None
    return ns / 1e6 / run.window.queries
