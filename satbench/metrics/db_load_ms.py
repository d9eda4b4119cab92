"""db_load_ms (ms): the session's DB load, parse and pack
(SearchSession.load_ms, the program's span).
"""

def read(run):
    return run.session["load_ms"]
