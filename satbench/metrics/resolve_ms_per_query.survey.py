"""resolve_ms_per_query.survey (ms): the program's session.resolve_query
spans in the traced window (lookup and pack_query), total time per query.
"""

from satbench.program_spans import per_query_ms, total_ns


def read(run):
    return per_query_ms(run, total_ns(run, "session.resolve_query"))
