"""The lanes per chain of the SA launch plan, on the CPU.

Where an unsplit launch pair fits in one wave of the card, each launch
class runs a chain on G lanes (csrc/sa_search.cu; ``sa_kernel.LANES``),
G chosen by ``sa_kernel.chain_lanes``: the narrow class's first, then
the wide class's, each the largest at which the classes' K x entries
over their CTA slots at that G stay within one wave, and at which the
class's K x entries x G stay within the card's SMs or each lane keeps
``LANE_SSES`` of the query's padded SSEs.  With occupancy stubbed as an
H100's registers allow it (48 registers a thread: 10 // G CTAs of
128 x G threads per SM, the wide class held to 5 by its shared memory):

* one 586-entry query at r = 128 runs its 30 wide CTAs on 4 lanes, and
  its 556 narrow ones on 1 lane at n1r 8 and 16 and on 2 from n1r 24;
* G = 1 where the launches split (r = 4096), for a 64-query tile, for
  a 14,291-entry query (about 10 waves) and off a card (no occupancy
  query);
* every G the rule gives is the largest that fits, by queries and
  entries (a mesh's smaller shards take more lanes);
* ``launch_figures`` stay the one-lane kernel's;
* a replayed graph adds its capture's lane launches to
  ``sa_search.lane_launches``.

The lane kernel is held against the one-lane kernel on the card in
tests/test_torch_chain_lanes_card.py.
"""

import dataclasses
import os
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import (  # noqa: E402
    kernel_search, sa_kernel)
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    LaunchClass, launch_figures)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (  # noqa: E402
    LANE_SSES, LANES, chain_lanes, launch_shape)
from cuda_satabsearch_tpu_torch.ops.search import Searcher  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
SMS = 132


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def per_sm(d2max, lanes):
    """CTAs per SM of the stub: 10 // G by registers, the wide class
    held to 5 by its shared memory."""
    return min(5 if d2max > 32 else 10, 10 // lanes)


def fake_occupancy(calls):
    def occupancy(d2max, n1r, c_par, lsoln, split=False, lanes=1):
        calls.append((d2max, n1r, c_par, lsoln, lanes))
        return per_sm(d2max, lanes), 48, 0
    return occupancy


@pytest.fixture
def on_a_card(monkeypatch):
    """The 586-entry DB's plan on ``SMS`` SMs, occupancy stubbed;
    returns (session, the stub's calls)."""
    calls = []
    monkeypatch.setattr(kernel_search, "sm_count", lambda device: SMS)
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    sess = SearchSession(DB586, SessionConfig(maxstart=128, device="cpu"))
    return sess, calls


def waves(plan, K, lanes):
    return sum(Fraction(K * cls.entries, SMS * per_sm(cls.d2max, g))
               for cls, g in zip(plan.classes, lanes))


def fake_plan(entries):
    """A plan of two launch classes (wide d2 112, narrow d2 32) of the
    given entries each, on ``SMS`` SMs: all that the rule reads."""
    return SimpleNamespace(sms=SMS, device=torch.device("cpu"), classes=[
        LaunchClass(buckets=[(SimpleNamespace(index=np.zeros(n)), 0)],
                    d2max=d2, desc=None)
        for n, d2 in zip(entries, (112, 32))])


@pytest.mark.parametrize("n1r, narrow", [(8, 1), (16, 1), (24, 2), (32, 2),
                                          (56, 2)])
def test_one_586_entry_query_runs_wide_4(on_a_card, n1r, narrow):
    """30 wide and 556 narrow CTAs a query.  The narrow class fills the
    SMs (556 > 132), so it takes 2 lanes only where each keeps 12 of
    n1r (556 / 660 + 30 / 660 = 0.89 waves), and never 4 (2.1 waves);
    the wide class takes 4 (4 x 30 <= 132; + 30 / 264: 0.96 waves at
    narrow 2)."""
    sess, _ = on_a_card
    plan = sess.device_db[0]
    assert [cls.entries for cls in plan.classes] == [30, 556]
    lanes = chain_lanes(plan, 1, n1r, c_par=128, lsoln=True, split=1)
    assert lanes == (4, narrow)
    assert waves(plan, 1, (4, 2)) == Fraction(30, 264) + Fraction(556, 660)
    assert waves(plan, 1, (1, 4)) > 1


@pytest.mark.parametrize("r_seq", [2, 8, 32])
def test_no_lanes_where_the_launches_split(on_a_card, r_seq):
    """Given the split, the rule asks for no lane count."""
    sess, calls = on_a_card
    plan = sess.device_db[0]
    split, lanes = launch_shape(plan, 1, 16, c_par=128, r_seq=r_seq,
                                lsoln=False)
    assert split > 1 and lanes == (1, 1)
    assert {c[-1] for c in calls} == {1}


@pytest.mark.parametrize("r_seq", [1, 3])
def test_no_lanes_for_a_64_query_tile(on_a_card, r_seq):
    sess, calls = on_a_card
    plan = sess.device_db[0]
    assert launch_shape(plan, 64, 16, c_par=128, r_seq=r_seq,
                        lsoln=True) == (1, (1, 1))
    # 29.9 waves at one lane: no lane count is asked for
    assert {c[-1] for c in calls} == {1}


def test_no_lanes_for_a_14291_entry_query(monkeypatch):
    """The ASTRAL-scale DB's 259 wide and 14,032 narrow CTAs a query:
    about 10.8 waves at one lane."""
    calls = []
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    plan = fake_plan((259, 14032))
    assert waves(plan, 1, (1, 1)) > 10
    assert chain_lanes(plan, 1, 16, c_par=128, lsoln=True,
                       split=1) == (1, 1)
    assert {c[-1] for c in calls} == {1}


def test_no_lanes_off_a_card(monkeypatch):
    calls = []
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    sess = SearchSession(DB586, SessionConfig(maxstart=128, device="cpu"))
    plan = sess.device_db[0]
    assert plan.sms == 0
    assert launch_shape(plan, 1, 16, c_par=128, r_seq=1,
                        lsoln=True) == (1, (1, 1))
    assert calls == []


@pytest.mark.parametrize("n1r", [8, 24, 104])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("entries", [(30, 556), (15, 278), (8, 139),
                                     (4, 70), (0, 586), (60, 0), (200, 900)])
def test_each_class_takes_the_most_lanes_that_fit(monkeypatch, K, entries,
                                                   n1r):
    """The narrow class's G is the largest that fits beside the wide
    class at one lane, the wide class's the largest that fits beside
    that, each also within the SMs or ``LANE_SSES`` a lane; a mesh's
    smaller shards take more lanes."""
    calls = []
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    plan = fake_plan(entries)
    plan.classes = [cls for cls in plan.classes if cls.entries]
    lanes = chain_lanes(plan, K, n1r, c_par=128, lsoln=False, split=1)
    assert len(lanes) == len(plan.classes)
    assert all(g in LANES for g in lanes)
    if waves(plan, K, (1,) * len(lanes)) > 1:
        assert set(lanes) == {1}
        return
    assert waves(plan, K, lanes) <= 1

    def allowed(cls, g):
        return K * cls.entries * g <= SMS or LANE_SSES * g <= n1r

    assert all(g == 1 or allowed(cls, g)
               for cls, g in zip(plan.classes, lanes))
    order = sorted(range(len(lanes)), key=lambda i: plan.classes[i].d2max)
    for n, i in enumerate(order):  # one more step of G would not do
        if lanes[i] < LANES[-1]:
            more = [lanes[j] if j in order[:n + 1] else 1
                    for j in range(len(lanes))]
            more[i] *= 2
            assert (waves(plan, K, more) > 1
                    or not allowed(plan.classes[i], more[i]))
    # the class's CTA slots at each G asked once, and kept
    asked = len(calls)
    chain_lanes(plan, K, n1r, c_par=128, lsoln=False, split=1)
    assert len(calls) == asked <= len(plan.classes) * len(LANES)


def test_launch_figures_stay_the_one_lane_kernels(on_a_card):
    sess, _ = on_a_card
    plan = sess.device_db[0]
    assert launch_shape(plan, 1, 24, c_par=128, r_seq=1,
                        lsoln=True) == (1, (4, 2))
    assert launch_figures(plan, 1, 24, c_par=128, r_seq=1, lsoln=True,
                          maxiter=100) == (586, SMS * (5 + 10), 100)
    assert launch_figures(plan, 1, 16, c_par=128, r_seq=1, lsoln=True,
                          maxiter=100) == (586, SMS * (5 + 10), 100)


def test_a_replay_adds_its_captures_lane_launches(on_a_card, monkeypatch):
    """The graph path with a capture that runs the function itself and a
    stand-in for the wrapper that counts as the card's would (a launch
    with G > 1 adds one lane launch): the capture's count is the step's,
    each replay adds it, and a 64-query list adds none."""
    sess, _ = on_a_card
    plan = sess.device_db[0]
    real, replaying = kernel_search.sa_search, []

    def counted(*args, **kw):
        # a replay runs no Python on the card: the step adds its counts
        if not replaying:
            K, n1r = args[0].shape
            _, lanes = launch_shape(args[4], K, n1r, c_par=kw["c_par"],
                                    r_seq=kw["r_seq"], lsoln=kw["lsoln"])
            counted.launches += len(lanes)
            counted.lane_launches += sum(g > 1 for g in lanes)
        return real(*args, **kw)

    def capture(fn):
        fn()

        def replay():
            replaying.append(fn)
            fn()
            replaying.pop()
        return replay

    counted.launches = counted.split_launches = counted.lane_launches = 0
    monkeypatch.setattr(kernel_search, "sa_search", counted)
    maxiter2 = dataclasses.replace(DEFAULTS, maxiter=2)
    # 2 chains of one restart, on the kernel's wrapper
    searcher = Searcher(sess.db, [plan], maxstart=2, c_max=2, seed=5,
                        params=maxiter2)
    searcher.capture = capture
    # a 19-SSE query: both classes take lanes
    q = sess.resolve_query(next(nm for nm, o in zip(sess.db.names,
                                                     sess.db.orders)
                                if o == 19))
    for _ in range(2):  # a key's second search captures its graph
        searcher.search(q, 0, lorder=True, lsoln=True)
    (g,) = searcher.graphs.values()
    assert g.steps[0].launches == (2, 0, 2)
    # the two eager searches; the capture's launches are the step's
    assert (counted.launches, counted.lane_launches) == (4, 4)
    for _ in range(3):
        searcher.search(q, 0, lorder=True, lsoln=True)
    assert (counted.launches, counted.lane_launches) == (10, 10)
    before = counted.launches, counted.lane_launches
    qs = [sess.resolve_query(nm) for nm, o in zip(sess.db.names,
                                                   sess.db.orders)
          if 9 <= o <= 16][:64]
    searcher.drain([searcher.launch(qs, list(range(64)), lorder=True,
                                    lsoln=False)])
    assert (counted.launches - before[0],
            counted.lane_launches - before[1]) == (2, 0)
