"""What the metric readers (``metrics/<name>.py``) compute from a run
(run.Run): shared by the readers of one quantity split by cell kind."""

from __future__ import annotations

import numpy as np

from . import bound

SA_KERNEL = "sa_plan_kernel"  # the SA kernel's name in the device trace


def iterations(run) -> int:
    """SA iterations the window's answered queries ran: entries x
    restarts x iterations per query (the reference's unit of work,
    cudaSaTabsearch.cu:1079)."""
    c = run.cell.config
    return (len(run.window.n1s) * run.nentries * int(c["maxstart"])
            * int(c["maxiter"]))


def latency_ms(run, q: float):
    if run.cell.traffic["loop"] != "search" or not run.window.latencies_ms:
        return None
    return float(np.percentile(run.window.latencies_ms, q))


def idle_share(run):
    """Per cent of the traced window in which the device ran nothing."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def host_ms_per_query(run):
    """Window wall less device busy time, per query (ms)."""
    t = run.trace
    if t is None or not run.window.queries:
        return None
    return (t.window_s - t.busy_s()) * 1e3 / run.window.queries


def sa_launches_per_query(run):
    if not run.window.queries:
        return None
    return run.window.sa_launches / run.window.queries


def sa_roofline(run):
    """Per cent of the SA kernel's device time (the union of its
    launches' intervals in the window) that the card's bound for the
    window's searches takes (bound.py)."""
    t = run.trace
    if t is None:
        return None
    kernel_s = t.busy_s(SA_KERNEL)
    if kernel_s <= 0:
        return None
    c, w = run.cell.config, run.window
    ops = bound.search_ops(w.n1s, run.nentries, int(c["maxstart"]),
                           int(c["maxiter"]))
    nbytes = (w.calls * bound.db_bytes(run.orders)
              + bound.search_bytes(w.n1s, run.orders, run.lsoln)
              - bound.db_bytes(run.orders))
    least = bound.bound_s(ops, nbytes, run.kind)
    return None if least is None else 100.0 * least / kernel_s
