"""search_self_ms_per_query.interactive (ms): self time of the program's
session.search spans in the traced window (building the SearchResults and
the glue between launch and drain), per query.
"""

from satbench.program_spans import per_query_ms, self_ns


def read(run):
    return per_query_ms(run, self_ns(run, "session.search"))
