"""sa_launches_per_query.survey (launches/query): SA kernel launches in the
window (the program's sa_search.launches counter) per query.
"""

from satbench.layers import sa_launches_per_query


def read(run):
    return sa_launches_per_query(run)
