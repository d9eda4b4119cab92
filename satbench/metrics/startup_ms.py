"""startup_ms (ms): the session's device start-up (SearchSession.warmup_s,
the program's span).
"""

def read(run):
    return run.session["warmup_s"] * 1e3
