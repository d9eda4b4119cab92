"""stats_ms_per_query.survey (ms): the program's stats.score_stats spans in
the traced window (norm2, z and p of one query), total time per query.
"""

from satbench.program_spans import per_query_ms, total_ns


def read(run):
    return per_query_ms(run, total_ns(run, "stats.score_stats"))
