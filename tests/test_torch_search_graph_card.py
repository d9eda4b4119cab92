"""On the card (skipped elsewhere): one query's search as a replayed CUDA
graph of its step (ops/search.py ``Searcher``, ops/kernel_search.py
``Step.capture``) against the eager path.

* On the 586-entry DB and a seeded 14,291-entry one, for one query of
  every round8 width of the DB and each of LORDER and LSOLN true and
  false: the key's first search (eager), its second (eager, then the
  capture) and its third (replay) equal, bit for bit, a session that
  searches eagerly only, on scores and maps.
* Each replay gives the plan's ``sa_plan_kernel`` records in a CUDA-only
  ``torch.profiler`` trace (as the benchmark's traced window runs), and
  the replays counted through the capture seam and ``sa_search.launches``
  count them.

On the card's host, which has no JAX (that ``tests/conftest.py``
imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_search_graph_card.py
"""

import os

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch.ops.common import round8
from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig
from cuda_satabsearch_tpu_torch.synthetic import astral_entries

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


def count_replays(sess) -> list:
    """The session's graph replays, counted through its capture seam
    (ops/search.Searcher.capture)."""
    replays, capture = [], sess.searcher.capture

    def counted(fn):
        replay = capture(fn)
        return lambda: replays.append(replay())
    sess.searcher.capture = counted
    return replays


def sessions(name):
    """(a session with graphs, a session that searches eagerly only)."""
    entries = None if name == "586" else astral_entries(14291, seed=13)
    dbfile = DB586 if name == "586" else "<synthetic>"
    graphs, eager = (SearchSession(dbfile, SessionConfig(), entries=entries)
                     for _ in range(2))
    eager.searcher.capture = None
    return graphs, eager


@pytest.mark.parametrize("db", ["586", "14291"])
def test_graph_search_equals_the_eager_search(card, db):
    sess, eager = sessions(db)
    assert sess.searcher.capture is not None
    firsts = {}
    for i, o in enumerate(sess.db.orders):
        firsts.setdefault(round8(int(o)), sess.db.names[i])
    replays = count_replays(sess)
    checked = 0
    for width, name in sorted(firsts.items()):
        q = sess.resolve_query(name)
        for lorder in (True, False):
            for lsoln in (True, False):
                tag = 1000 + width + 2 * lorder + lsoln
                ref = eager.search(q, lorder=lorder, lsoln=lsoln,
                                   query_tag=tag)
                for _ in range(3):  # eager, eager and capture, replay
                    got = sess.search(q, lorder=lorder, lsoln=lsoln,
                                      query_tag=tag)
                    np.testing.assert_array_equal(got.scores, ref.scores)
                    if lsoln:
                        np.testing.assert_array_equal(got.ssemaps,
                                                      ref.ssemaps)
                    else:
                        assert got.ssemaps is None
                checked += 1
    assert len(replays) == checked
    assert len(sess.searcher.graphs) == checked
    print(f"\n{card}: {db} entries, {len(firsts)} widths x LORDER x LSOLN:"
          f" {checked} keys, graph == eager bitwise")


def test_each_replay_gives_the_kernel_records(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess, _ = sessions("586")
    replays = count_replays(sess)
    names = sess.db.names[::5]
    queries = [sess.resolve_query(n) for n in names]
    for q in queries:  # every key's first and second search (captures)
        for _ in range(2):
            sess.search(q, lsoln=True)
    torch.cuda.synchronize()
    launches, replayed = sa_search.launches, len(replays)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for q in queries:
            sess.search(q, lsoln=True)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA
               and "sa_plan_kernel" in ev.name()]
    per = len(sess.device_db[0].classes)
    n = len(queries)
    print(f"\n{card}: {n} replays, {len(kernels)} sa_plan_kernel records, "
          f"{sa_search.launches - launches} launches counted")
    assert per == 2
    assert len(replays) - replayed == n
    assert sa_search.launches - launches == per * n
    assert len(kernels) == per * n
