"""setup_s (s): process start to the first timed call, less the making of
the cell's DB file (host clock).
"""

def read(run):
    return run.setup_s
