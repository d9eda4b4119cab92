"""query_ms_p95 (ms): 95th percentile of the wall of one query over every
query of the window (host clock).
"""

from satbench.layers import latency_ms


def read(run):
    return latency_ms(run, 95)
