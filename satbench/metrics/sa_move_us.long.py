"""sa_move_us.long (us): the time of one dependent move of the longest
chain.  The SA kernel's device time in the traced window (the union of
its launches' intervals, as ``layers.sa_roofline`` takes it) over the
sum of ``chain_moves`` (maxiter x r_seq) of the program's
kernel_search.enqueue spans that began in the window; it includes each
restart's initialisation.  None where no such span carries
``chain_moves`` or the trace holds no SA kernel.
"""

from satbench.layers import SA_KERNEL
from satbench.program_spans import recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    lo = run.trace.window_ns[0]
    moves = sum(getattr(s, "chain_moves", 0) for s in spans
                if s.name == "kernel_search.enqueue" and s.start_ns >= lo)
    kernel_s = run.trace.busy_s(SA_KERNEL)
    if moves <= 0 or kernel_s <= 0:
        return None
    return kernel_s * 1e6 / moves
