"""enqueue_ms_per_query.interactive (ms): the program's kernel_search.enqueue
spans in the traced window (argument checks, the launches, the side-stream
fork and join), total time per query.
"""

from satbench.program_spans import per_query_ms, total_ns


def read(run):
    return per_query_ms(run, total_ns(run, "kernel_search.enqueue"))
