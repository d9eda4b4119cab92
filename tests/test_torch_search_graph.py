"""One search step for the eager path and the replayed graph
(cuda_satabsearch_tpu_torch/ops/kernel_search.py ``Step``,
ops/search.py ``Searcher``), on the CPU.

A CUDA graph needs a card; here the searcher's ``capture`` returns a
replay that runs the captured function itself (counting captures and
replays), so that each replay runs the plain engine through the same
staging, gather and copy-out as the graph does.

* The route: ``SearchSession.search`` uses graphs only with the kernel's
  backend and no mesh; ``-c``, ``--backend torch`` and a mesh search
  eagerly.
* A key's first two searches are eager, the second captures its step
  after the drain, later ones replay; every result equals the eager
  path's, bit for bit, in arrays of its own.
* The step's gather into file order and a mesh's placement equal a
  per-entry reference on DBs with padding and buckets in both launch
  classes; a whole DB's plan must hold every entry.
* The staging buffer holds ``pack_queries``'s bytes for widths 8-112,
  for one replayed query and for a list, and the tags as uint32 bits.
* The counters: one capture per key searched twice, one replay per
  search after a key's second, and each replay's launches.
* Distances off the bf16 grid are refused on the graph path too.
* The graph path records the eager path's spans, the drain's bytes too.

The card's graphs are held against the eager path in
tests/test_torch_search_graph_card.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch import trace  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import (  # noqa: E402
    DEFAULT_BUCKETS, pack_database, pack_query)
from cuda_satabsearch_tpu_torch.io.writer import format_database  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import kernel_search  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    make_plan, pack_queries, query_layout)
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    search_db_many, upload_db, uses_graphs)
from cuda_satabsearch_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

from conftest import random_entry  # noqa: E402

ORDERS = [3, 5, 9, 14, 27, 40, 50, 70]  # narrow and wide buckets


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dbfile(tmp_path_factory):
    rng = np.random.default_rng(21)
    entries = [random_entry(rng, n, f"e{i}") for i, n in enumerate(ORDERS)]
    path = tmp_path_factory.mktemp("db") / "db.ascii"
    path.write_text(format_database(entries))
    return str(path)


def session(dbfile, **kw):
    return SearchSession(dbfile, SessionConfig(maxstart=2, device="cpu",
                                               **kw))


class Capture:
    """A capture for the CPU: like ``torch.cuda.graph`` it runs the
    function once while capturing (``capturing`` is true then), and its
    replay runs the function again; both are counted."""

    def __init__(self):
        self.captures = self.replays = 0
        self.capturing = False

    def __call__(self, fn):
        self.captures += 1
        self.capturing = True
        try:
            fn()
        finally:
            self.capturing = False

        def replay():
            self.replays += 1
            fn()
        return replay


def attach(sess) -> Capture:
    """Give a CPU session the graphs and the kernel's wrapper (which runs
    the plain engine on the CPU) that a card's session has."""
    sess.searcher.kw["backend"] = "cuda"
    sess.searcher.capture = Capture()
    return sess.searcher.capture


@pytest.mark.parametrize("backend, mesh, route", [
    ("cuda", None, True), ("torch", None, False),
    ("cuda", ["cuda:0"], False), ("cuda", ["cuda:0", "cuda:1"], False),
    ("torch", ["cpu"], False)])
def test_graphs_only_for_the_kernel_on_one_card(backend, mesh, route):
    assert uses_graphs(backend, mesh) is route


@pytest.mark.parametrize("kw", [{}, {"backend": "torch"},
                                {"use_mesh": True, "devices": ["cpu"]},
                                {"use_mesh": True, "devices": ["cpu"] * 2}])
def test_cpu_torch_and_mesh_sessions_search_eagerly(dbfile, kw):
    sess = session(dbfile, **kw)
    assert sess.backend == "torch" and sess.searcher.capture is None
    q = sess.resolve_query("e2")
    first, second, third = (sess.search(q, query_tag=3) for _ in range(3))
    np.testing.assert_array_equal(first.scores, second.scores)
    np.testing.assert_array_equal(first.scores, third.scores)
    assert sess.searcher.graphs == {}


def test_two_eager_searches_the_second_captures_later_ones_replay(dbfile):
    ref = session(dbfile)
    sess = session(dbfile)
    cap = attach(sess)
    # (query, lorder, lsoln, graphs captured after it, replayed); keys
    # (n1r, lorder, lsoln): e0 and e1 share n1r 8, e5 has 40 and e6 56
    calls = [("e0", True, True, 0, 0), ("e1", True, True, 1, 0),
             ("e0", True, True, 1, 1), ("e5", False, True, 1, 0),
             ("e0", True, True, 1, 1), ("e1", True, False, 1, 0),
             ("e5", False, True, 2, 0), ("e1", True, True, 2, 1),
             ("e6", True, False, 2, 0), ("e1", True, False, 3, 0)]
    for name, lorder, lsoln, n, replayed in calls:
        q = sess.resolve_query(name)
        replays = cap.replays
        got = sess.search(q, lorder=lorder, lsoln=lsoln, query_tag=9)
        exp = ref.search(q, lorder=lorder, lsoln=lsoln, query_tag=9)
        assert cap.captures == n
        assert cap.replays - replays == replayed
        np.testing.assert_array_equal(got.scores, exp.scores)
        assert got.scores.dtype == np.int32
        if lsoln:
            np.testing.assert_array_equal(got.ssemaps, exp.ssemaps)
            assert got.ssemaps.shape == (sess.nentries, q.order)
        else:
            assert got.ssemaps is None
        assert (got.names, got.query_order) == (exp.names, q.order)
    assert sorted(sess.searcher.graphs) == [(8, True, False),
                                            (8, True, True),
                                            (40, False, True)]


def test_results_are_arrays_of_their_own(dbfile):
    sess = session(dbfile)
    attach(sess)
    q = sess.resolve_query("e3")
    for _ in range(2):
        sess.search(q, query_tag=1)
    a = sess.search(q, query_tag=1)
    b = sess.search(sess.resolve_query("e2"), query_tag=2)  # same key
    c = sess.search(q, query_tag=1)
    np.testing.assert_array_equal(a.scores, c.scores)
    np.testing.assert_array_equal(a.ssemaps, c.ssemaps)
    for x in (a, b, c):
        assert x.scores.base is None and x.ssemaps.base is None


def _db_with_padding(seed, pad_to):
    """Entries in every bucket of DEFAULT_BUCKETS, so both launch classes
    hold several buckets, padded to ``pad_to`` rows per bucket."""
    r = np.random.default_rng(seed)
    lows = (2,) + tuple(c + 1 for c in DEFAULT_BUCKETS[:-1])
    orders = [int(r.integers(lo, min(cap, 111) + 1))
              for lo, cap in zip(lows, DEFAULT_BUCKETS) for _ in range(2)]
    r.shuffle(orders)
    return pack_database([random_entry(r, o, f"e{i}")
                          for i, o in enumerate(orders)], pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [1, 3, 4])
@pytest.mark.parametrize("lsoln", [True, False])
def test_file_order_gather_equals_the_drain_scatter(pad_to, lsoln,
                                                    monkeypatch):
    """An engine whose every output names its (query tag, entry): the
    step's gather of the whole DB's plan (padding dropped) and the
    drain's placement of a mesh of ``pad_to`` shards (padding last in
    each) give each entry's values at its file index."""
    db = _db_with_padding(30 + pad_to, pad_to)
    (whole,) = upload_db(db, "cpu")
    shards = upload_db(db, make_mesh(["cpu"] * pad_to))
    assert [len(c.buckets) > 1 for c in whole.classes] == [True, True]
    assert (whole.index < 0).any() == (pad_to > 1)
    assert whole.whole and len(whole.file_index) == db.nentries
    for plan in shards:
        assert plan.whole == (pad_to == 1)
        n = np.count_nonzero(plan.file_index >= 0)
        assert (plan.file_index[n:] == -1).all()
        assert (np.diff(plan.file_index[:n]) > 0).all()
    K, n1r, tags = 3, 16, [5, 6, 2 ** 31 + 7]

    def by_entry(qtypes, qtab, qdmat, n1s, plan, *, tags, lsoln, **kw):
        k = tags.to(torch.int64).remainder(2 ** 32)[:, None]
        s = 1000 * k + torch.from_numpy(plan.index.astype(np.int64))
        m = 7 * s[..., None] + torch.arange(n1r) if lsoln else None
        return s.to(torch.int32), None if m is None else m.to(torch.int32)

    monkeypatch.setattr(kernel_search, "search_plan_plain", by_entry)
    r = np.random.default_rng(pad_to)
    queries = [pack_query(random_entry(r, o, "q")) for o in (16, 9, 12)]
    for plans in ([whole], shards):
        got = search_db_many(queries, db, plans, query_tags=tags,
                             lsoln=lsoln, maxstart=2, backend="torch")
        for t, q, res in zip(tags, queries, got):
            want = (1000 * t + np.arange(db.nentries)).astype(np.int32)
            np.testing.assert_array_equal(res.scores, want)
            if lsoln:
                np.testing.assert_array_equal(
                    res.ssemaps, (7 * want[:, None].astype(np.int64)
                                  + np.arange(q.order)).astype(np.int32))
            else:
                assert res.ssemaps is None


def test_file_order_refuses_a_plan_without_every_entry():
    db = _db_with_padding(40, 2)
    (plan,) = upload_db(db, "cpu")
    with pytest.raises(ValueError, match="every entry"):
        make_plan(plan.buckets[1:], nentries=db.nentries)
    make_plan(plan.buckets[1:])  # a shard's plan: any subset


@pytest.mark.parametrize("n1r", range(8, 113, 8))
def test_staging_holds_pack_queries_bytes(tmp_path, n1r):
    """One query's captured group (restaged at its replay) and a list of
    three: the queries' parts and gaps are ``pack_queries``'s bytes, the
    tags their uint32 values."""
    r = np.random.default_rng(n1r)
    entries = [random_entry(r, 4, "e0"), random_entry(r, 6, "e1")]
    path = tmp_path / "db.ascii"
    path.write_text(format_database(entries))
    sess = SearchSession(str(path), SessionConfig(maxstart=1, device="cpu"))
    attach(sess)
    qs = [pack_query(random_entry(
        r, int(r.integers(n1r - 7, min(n1r, 111) + 1)), f"q{k}"))
        for k in range(3)]
    tag = 2 ** 32 + 2 ** 31 + n1r
    for _ in range(3):  # eager, eager and capture, replay
        sess.search(qs[0], lsoln=False, query_tag=tag)
    one = sess.searcher.graphs[(n1r, True, False)].staging.buf
    tags = [tag, -1, 7]
    listed = sess.searcher.launch(qs, tags, lorder=True, lsoln=False)
    sess.searcher.drain([listed])
    for staged, queries, ts in ((one, qs[:1], [tag]),
                                (listed.staging.buf, qs, tags)):
        layout, size = query_layout(len(queries), n1r)
        at = layout[4][2]  # the tags' offset
        want = bytes(pack_queries(queries, n1r, "cpu")[0].untyped_storage())
        got = staged.numpy()
        assert len(want) == size and got.nbytes == size
        assert got[:at].tobytes() == want[:at]
        assert got[at:].view(np.uint32)[:len(ts)].tolist() == [
            t & 0xFFFFFFFF for t in ts]


def test_counters_count_captures_replays_and_launches(dbfile, monkeypatch):
    real = kernel_search.sa_search

    def counted(*args, **kw):
        # on a card the wrapper's Python, which counts the launches, runs
        # while the graph is captured and not when it is replayed
        counted.launches += len(args[4].classes) * cap.capturing
        return real(*args, **kw)

    counted.launches = counted.split_launches = counted.lane_launches = 0
    monkeypatch.setattr(kernel_search, "sa_search", counted)
    sess = session(dbfile)
    cap = attach(sess)
    per = len(sess.device_db[0].classes)
    assert per == 2
    names = ["e0", "e1", "e0", "e0", "e6", "e1", "e7", "e0"]
    # keys (n1r): 8, 8, 8, 8, 56, 8, 72, 8: 3 first searches and one
    # second (eager; the second captures), 4 replays
    for name in names:
        sess.search(sess.resolve_query(name), query_tag=0)
    assert cap.captures == 1
    assert cap.replays == len(names) - 4
    assert counted.launches == per * (len(names) - 4)
    assert counted.split_launches == 0  # r_seq 1: nothing to split


def test_distances_off_the_bf16_grid_are_refused_on_the_graph_path(dbfile):
    sess = session(dbfile)
    cap = attach(sess)
    good = sess.resolve_query("e1")
    bad = sess.resolve_query("e0")
    bad.dmat[0, 1] = np.float32(3.14159)
    with pytest.raises(ValueError, match="bf16 grid"):
        sess.search(bad)  # eager
    for _ in range(2):
        sess.search(good)  # eager; the second captures the key's graph
    assert (8, True, True) in sess.searcher.graphs
    with pytest.raises(ValueError, match="bf16 grid"):
        sess.search(bad)  # the graph path
    assert cap.replays == 0
    ref = session(dbfile).search(good, query_tag=4)
    np.testing.assert_array_equal(sess.search(good, query_tag=4).scores,
                                  ref.scores)
    assert cap.replays == 1


@pytest.mark.parametrize("lsoln", [True, False])
def test_graph_path_records_the_eager_spans(dbfile, lsoln):
    sess = session(dbfile)
    attach(sess)
    q = sess.resolve_query("e4")
    n1r, E = 32, sess.nentries
    with trace.recording():
        sess.search(q, lsoln=lsoln, query_tag=5)  # eager
        eager = trace.spans()
        sess.search(q, lsoln=lsoln, query_tag=5)  # eager, then captures
        assert [s.name for s in trace.spans()] == 2 * [s.name
                                                       for s in eager]
        trace.clear()
        sess.search(q, lsoln=lsoln, query_tag=6)  # replays
        sess.search(q, lsoln=lsoln, query_tag=7)
    spans = trace.spans()
    assert [s.name for s in spans] == 2 * [s.name for s in eager]
    for first, s in zip(eager + eager, spans):
        assert (s.parent >= 0) == (first.parent >= 0)
        assert s.nbytes == first.nbytes
        assert (s.ctas, s.cta_slots, s.chain_moves) == (
            first.ctas, first.cta_slots, first.chain_moves)
    by = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "kernel_search.enqueue":
            assert by[s.parent].name == "kernel_search.launch_group"
            assert (s.tag, s.queries) == (by[s.parent].tag, 1)
        if s.name == "kernel_search.drain":
            assert by[s.parent].name == "session.search"
            assert s.nbytes == 4 * E * (1 + (n1r if lsoln else 0))
    assert [s.tag for s in spans if s.name == "session.search"] == [6, 7]
