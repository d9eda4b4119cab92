"""sa_cta_fill.long (%): how much of the card the SA launches fill.  For
each of the program's kernel_search.enqueue spans that began in the
traced window, 100 x min(1, ctas / cta_slots): the CTAs of its launches'
grids over the CTAs the card holds at once for them (trace.Span's launch
figures); averaged over those spans.  None where no such span carries
``cta_slots`` (an untraced run, the CPU, a program without the figures).
"""

from satbench.program_spans import recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    lo = run.trace.window_ns[0]
    fills = [100.0 * min(1.0, s.ctas / s.cta_slots) for s in spans
             if s.name == "kernel_search.enqueue" and s.start_ns >= lo
             and getattr(s, "cta_slots", 0) > 0]
    return sum(fills) / len(fills) if fills else None
