"""host_ms_per_query.interactive (ms): traced window wall less device busy
time, per query.
"""

from satbench.layers import host_ms_per_query


def read(run):
    return host_ms_per_query(run)
