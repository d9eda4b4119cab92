"""drain_idle_ms_per_query.interactive (ms): the device's idle time inside
the program's kernel_search.drain spans in the traced window (the host side
of the copies and the scatter to file order, not the wait for the kernel),
per query.
"""

from satbench.program_spans import idle_ns, per_query_ms


def read(run):
    return per_query_ms(run, idle_ns(run, "kernel_search.drain"))
