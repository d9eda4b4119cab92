"""launch_host_ms_per_query.interactive (ms): self time of the program's
kernel_search.launch_group spans in the traced window (the query pack and
upload, the tags upload, joining tiles: all but the enqueue), per query.
"""

from satbench.program_spans import per_query_ms, self_ns


def read(run):
    return per_query_ms(run, self_ns(run, "kernel_search.launch_group"))
