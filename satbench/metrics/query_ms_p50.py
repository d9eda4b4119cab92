"""query_ms_p50 (ms): median wall of one query (resolve, search ending in
its drain, score_stats), over every query of the window (host clock).
"""

from satbench.layers import latency_ms


def read(run):
    return latency_ms(run, 50)
