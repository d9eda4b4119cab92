"""Long chains (restarts run in order inside a chain) and the launch
figures of the ``kernel_search.enqueue`` span, on the CPU.

* At 258 restarts (86 parallel chains of 3 restarts each,
  ``choose_chains``), on 8 entries of the 586-entry DB, the session's
  plain path equals the benchmark's plain reference
  (satbench/reference/sa.py) bit for bit, for each of LORDER and LSOLN
  true and false: scores, maps under LSOLN, and norm2 / z / p against
  satbench/reference/stats.py.
* The enqueue span carries the plan's launch figures: ``ctas``, one per
  (column, query) of each tile; ``chain_moves``, maxiter x r_seq;
  ``cta_slots``, the card's SMs times each launch class's resident CTAs
  per SM (``sa_kernel.occupancy``, stubbed here), queried once per class
  and key and never while nothing records; 0 off a card.  A replayed
  graph's enqueue span carries the figures of the launch it captured.
* Spans that nothing gave figures carry 0; an enqueue span carries its
  tile's n1r.

The figures are held on the card in tests/test_torch_long_chains_card.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch import trace  # noqa: E402
from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import (  # noqa: E402
    kernel_search, sa_kernel)
from cuda_satabsearch_tpu_torch.ops.common import round8  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.search import choose_chains  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)
from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats  # noqa: E402
from satbench.reference import dbfile, sa  # noqa: E402
from satbench.reference.stats import score_stats as ref_stats  # noqa: E402

MAXSTART = 258  # 86 chains x 3 restarts in order
SEED = 2 ** 31 - 77
SMS = 132
DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """(path, index) of 8 entries of the 586-entry DB, 3 to 36 SSEs:
    narrow and wide buckets, so both launch classes."""
    index = dbfile.index_file(DB586)
    by_order = np.argsort(index.orders, kind="stable")
    picks = sorted({int(by_order[k]) for k in
                    np.linspace(40, len(by_order) - 20, 8).astype(int)})
    lines = open(DB586).read().split("\n")
    path = tmp_path_factory.mktemp("db") / "eight.ascii"
    with open(path, "w") as fh:
        for i in picks:
            n = int(index.orders[i])
            fh.write("\n".join(lines[index.starts[i]:
                                     index.starts[i] + 1 + 2 * n]) + "\n\n")
    small = dbfile.index_file(str(path))
    assert len(small.names) == 8
    assert small.orders.min() <= 32 < small.orders.max()
    return str(path), small


def session(path):
    return SearchSession(path, SessionConfig(maxstart=MAXSTART, seed=SEED,
                                             device="cpu"))


@pytest.fixture(scope="module")
def sess(db):
    return session(db[0])


def test_258_restarts_run_as_86_chains_of_3():
    assert choose_chains(MAXSTART) == (86, 3)


@pytest.mark.parametrize("lsoln", [False, True])
@pytest.mark.parametrize("lorder", [True, False])
def test_long_chains_equal_the_reference(db, sess, lorder, lsoln):
    _, index = db
    entries = [index.entry(i) for i in range(len(index.names))]
    E = len(entries)
    qi = 2 * lorder + lsoln + 2  # a query of another width in each case
    tag = 40 + qi
    res = sess.search(sess.resolve_query(index.names[qi]), lorder=lorder,
                      lsoln=lsoln, query_tag=tag)
    scores, maps = sa.search_pairs([entries[qi]] * E, entries, [tag] * E,
                                   list(range(E)), seed=SEED,
                                   maxstart=MAXSTART, lorder=lorder,
                                   lsoln=lsoln, device="cpu")
    assert res.names == index.names
    np.testing.assert_array_equal(res.scores, scores)
    if lsoln:
        for e in range(E):
            np.testing.assert_array_equal(res.ssemaps[e], maps[e])
    got = score_stats(res.scores, entries[qi].order, res.orders)
    want = ref_stats(scores, entries[qi].order, index.orders)
    for g, w in zip(got, want):
        assert np.asarray(g, np.float64).tobytes() == w.tobytes()


def enqueues():
    return [s for s in trace.spans() if s.name == "kernel_search.enqueue"]


def test_the_enqueue_span_carries_the_plans_grids_and_chain(db, sess,
                                                           monkeypatch):
    """A search and a list in two tiles of 3 queries and one of 1: each
    tile's CTAs are its queries times the plan's columns (padding
    included), its chain maxiter x r_seq; no slots off a card."""
    monkeypatch.setattr(kernel_search, "K_TILE", 3)
    plan = sess.device_db[0]
    assert plan.sms == 0 and len(plan.classes) == 2
    narrow = [n for n, o in zip(db[1].names, db[1].orders) if o <= 8]
    qs = [sess.resolve_query(n) for n in (narrow * 7)[:7]]
    with trace.recording():
        sess.search(qs[0], lsoln=False)
        sess.search_many(qs)
    got = [(s.queries, s.ctas, s.cta_slots, s.chain_moves)
           for s in enqueues()]
    moves = DEFAULTS.maxiter * 3
    assert got == [(k, k * plan.nentries, 0, moves) for k in (1, 3, 3, 1)]


def fake_occupancy(calls):
    def occupancy(d2max, n1r, c_par, lsoln, lanes=1):
        calls.append((d2max, n1r, c_par, lsoln))
        return (3 if d2max > 32 else 7) + (n1r > 8) + lsoln, 48, 0
    return occupancy


@pytest.fixture
def on_a_card(db, monkeypatch):
    """A session whose plan holds ``SMS`` SMs, with ``occupancy`` stubbed;
    returns (session, the stub's calls)."""
    calls = []
    monkeypatch.setattr(kernel_search, "sm_count", lambda device: SMS)
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    return session(db[0]), calls


def test_cta_slots_are_sms_times_each_classs_occupancy(db, on_a_card):
    sess, calls = on_a_card
    plan = sess.device_db[0]
    assert plan.sms == SMS
    c_par, r_seq = choose_chains(MAXSTART)
    wide, narrow = (cls.d2max for cls in plan.classes)
    assert wide > 32 >= narrow
    names = db[1].names
    with trace.recording():
        for name, lsoln in [(names[0], False), (names[-1], True),
                            (names[0], False), (names[-1], True)]:
            q = sess.resolve_query(name)
            sess.search(q, lsoln=lsoln)
    spans = enqueues()
    n1r0, n1r1 = (round8(int(db[1].orders[i])) for i in (0, -1))
    want = [SMS * ((3 + (n1r0 > 8)) + (7 + (n1r0 > 8))),
            SMS * ((4 + (n1r1 > 8)) + (8 + (n1r1 > 8)))] * 2
    assert [s.cta_slots for s in spans] == want
    assert all(s.ctas == plan.nentries for s in spans)
    assert all(s.chain_moves == DEFAULTS.maxiter * r_seq for s in spans)
    # one query per class and key, none per search
    assert sorted(calls) == sorted(
        (cls.d2max, n1r, c_par, lsoln) for cls in plan.classes
        for n1r, lsoln in ((n1r0, False), (n1r1, True)))


def test_no_occupancy_query_while_nothing_records(db, on_a_card):
    sess, calls = on_a_card
    for name in db[1].names[:3]:
        sess.search(sess.resolve_query(name), lsoln=False)
    assert calls == [] and trace.spans() == []


def test_a_replay_carries_its_captures_figures(db, on_a_card):
    """The graph path on the CPU (the replay runs the captured function
    itself): each replay's enqueue span carries the figures of the
    launch it captured, the occupancy queried once per class."""
    sess, calls = on_a_card
    c_par, r_seq = choose_chains(sess.config.maxstart, sess.config.c_max)
    replays = []
    sess.searcher.capture = lambda fn: lambda: replays.append(fn()) or None
    q = sess.resolve_query(db[1].names[1])
    for _ in range(2):  # eager, eager and the capture
        sess.search(q, lsoln=False)
    assert list(sess.searcher.graphs) == [(round8(q.order), True, False)]
    assert calls == []  # r_seq 3 and nothing traced: no query yet
    with trace.recording():
        for _ in range(2):
            sess.search(q, lsoln=False)
    assert len(replays) == 2
    plan = sess.device_db[0]
    n1r = round8(q.order)
    assert [(s.ctas, s.cta_slots, s.chain_moves) for s in enqueues()] \
        == [(plan.nentries, SMS * ((3 + (n1r > 8)) + (7 + (n1r > 8))),
             DEFAULTS.maxiter * r_seq)] * 2
    assert len(calls) == len(plan.classes)


def test_spans_without_launches_carry_no_figures(db, sess):
    with trace.recording():
        trace.end(trace.begin("other"))
        trace.end(trace.begin("bytes"), 64)
        sess.search(sess.resolve_query(db[1].names[0]), lsoln=False)
    trace.end(None, 0, (1, 2, 3, 4))  # a no-op while nothing records
    spans = trace.spans()
    assert trace.Span("x", 0, 1, 0, -1, 0, -1, 0, 0)[-4:] == (0, 0, 0, 0)
    for s in spans:
        figures = (s.ctas, s.cta_slots, s.chain_moves, s.n1r)
        if s.name == "kernel_search.enqueue":
            assert figures[0] > 0 and figures[2] > 0 and figures[3] > 0
        else:
            assert figures == (0, 0, 0, 0)
    assert [s.nbytes for s in spans[:2]] == [0, 64]
