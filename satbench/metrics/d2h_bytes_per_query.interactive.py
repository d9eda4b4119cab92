"""d2h_bytes_per_query.interactive (B): the bytes of scores and maps
that the program's kernel_search.drain spans in the traced window
brought to the host (each span's ``nbytes``), per query.
"""

from satbench.program_spans import nbytes


def read(run):
    b = nbytes(run, "kernel_search.drain")
    if b is None or not run.window.queries:
        return None
    return b / run.window.queries
