"""sa_move_us.list (us): the card's time per dependent move of one wave of
chains.  The SA kernel's device time in the traced window (the union of
its launches' intervals, as ``layers.sa_roofline`` takes it) over the
sum, across the program's kernel_search.enqueue spans that began in the
window with ``cta_slots`` > 0, of ``chain_moves`` x ``ctas`` /
``cta_slots``: each launch's dependent moves a chain times the waves of
the card's CTA slots its grids fill.  A move's time where launches fill
whole waves; unlike ``sa_move_us.long`` it does not grow with the waves
a restart split adds.  None where no such span is recorded (an untraced
run, the CPU, a program without the figures) or the trace holds no SA
kernel.
"""

from satbench.layers import SA_KERNEL
from satbench.program_spans import recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    lo = run.trace.window_ns[0]
    moves = sum(s.chain_moves * s.ctas / s.cta_slots for s in spans
                if s.name == "kernel_search.enqueue" and s.start_ns >= lo
                and getattr(s, "cta_slots", 0) > 0)
    kernel_s = run.trace.busy_s(SA_KERNEL)
    if moves <= 0 or kernel_s <= 0:
        return None
    return kernel_s * 1e6 / moves
