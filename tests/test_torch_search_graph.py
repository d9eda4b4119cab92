"""One query's search as a replayed graph (cuda_satabsearch_tpu_torch/
ops/kernel_search.py ``QueryGraphs``), on the CPU.

A CUDA graph needs a card; here ``QueryGraphs`` takes a capture that
returns the function itself, so that each replay runs the plain engine
through the same staging, gather and copy-out as the graph does.

* The route: ``SearchSession.search`` uses graphs only with the kernel's
  backend and no mesh; ``-c``, ``--backend torch`` and a mesh search
  eagerly.
* A key's first two searches are eager, the second captures the key's
  graph after its drain, later ones replay; every result equals the
  eager path's, bit for bit.
* The file-order gather by ``file_order``'s inverse permutation equals
  ``drain``'s host scatter on plans with padding and buckets in both
  launch classes.
* The staging buffer holds ``pack_queries``'s bytes for widths 8-112, and
  the tag as uint32 bits.
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
    Launched, QueryGraphs, drain, file_order, make_plan, pack_queries,
    query_layout)
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    choose_chains, upload_db)
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig, uses_graphs)

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


def not_captured(fn):
    """A capture for the CPU: the replay runs ``fn`` itself."""
    return fn


def attach(sess, capture=not_captured) -> QueryGraphs:
    """Give a CPU session the graphs a card's session makes."""
    cfg = sess.config
    c_par, r_seq = choose_chains(cfg.maxstart, cfg.c_max)
    sess.graphs = QueryGraphs(sess.device_db[0], sess.nentries,
                              seed=cfg.seed, c_par=c_par, r_seq=r_seq,
                              params=cfg.params, capture=capture)
    return sess.graphs


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
    assert sess.backend == "torch" and sess.graphs is None
    before = kernel_search.graph_replays, kernel_search.graph_captures
    q = sess.resolve_query("e2")
    first, second = (sess.search(q, query_tag=3) for _ in range(2))
    np.testing.assert_array_equal(first.scores, second.scores)
    assert (kernel_search.graph_replays,
            kernel_search.graph_captures) == before


def test_two_eager_searches_the_second_captures_later_ones_replay(dbfile):
    ref = session(dbfile)
    sess = session(dbfile)
    captured = []
    attach(sess, lambda fn: captured.append(fn) or fn)
    # (query, lorder, lsoln, graphs captured after it, replayed); keys
    # (n1r, lorder, lsoln): e0 and e1 share n1r 8, e5 has 40 and e6 56
    calls = [("e0", True, True, 0, 0), ("e1", True, True, 1, 0),
             ("e0", True, True, 1, 1), ("e5", False, True, 1, 0),
             ("e0", True, True, 1, 1), ("e1", True, False, 1, 0),
             ("e5", False, True, 2, 0), ("e1", True, True, 2, 1),
             ("e6", True, False, 2, 0), ("e1", True, False, 3, 0)]
    for name, lorder, lsoln, n, replayed in calls:
        q = sess.resolve_query(name)
        replays = kernel_search.graph_replays
        got = sess.search(q, lorder=lorder, lsoln=lsoln, query_tag=9)
        exp = ref.search(q, lorder=lorder, lsoln=lsoln, query_tag=9)
        assert len(captured) == n
        assert kernel_search.graph_replays - replays == replayed
        np.testing.assert_array_equal(got.scores, exp.scores)
        assert got.scores.dtype == np.int32
        if lsoln:
            np.testing.assert_array_equal(got.ssemaps, exp.ssemaps)
            assert got.ssemaps.shape == (sess.nentries, q.order)
        else:
            assert got.ssemaps is None
        assert (got.names, got.query_order) == (exp.names, q.order)
    assert sorted(sess.graphs.graphs) == [(8, True, False), (8, True, True),
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
def test_file_order_gather_equals_the_drain_scatter(pad_to, lsoln):
    db = _db_with_padding(30 + pad_to, pad_to)
    (plan,) = upload_db(db, "cpu")
    assert [len(c.buckets) > 1 for c in plan.classes] == [True, True]
    assert (plan.index < 0).any() == (pad_to > 1)
    r = np.random.default_rng(pad_to)
    K, n1r, E = 3, 16, plan.nentries
    s = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31, (K, E), np.int32))
    m = (torch.from_numpy(r.integers(-1, 40, (K, E, n1r), np.int32))
         if lsoln else None)
    queries = [pack_query(random_entry(r, 16, "q"))] * K
    (want,) = drain([Launched(queries=queries, n1r=n1r, lsoln=lsoln,
                              outputs=[(plan.device, plan.index, s, m)])],
                    db.nentries)
    inverse = torch.from_numpy(file_order(plan.index, db.nentries))
    got_s = s.index_select(1, inverse).numpy()
    got_m = m.index_select(1, inverse).numpy() if lsoln else None
    for k, (ws, wm) in enumerate(want):
        np.testing.assert_array_equal(got_s[k], ws)
        if lsoln:
            np.testing.assert_array_equal(got_m[k], wm)


def test_file_order_refuses_a_plan_without_every_entry():
    db = _db_with_padding(40, 2)
    (plan,) = upload_db(db, "cpu")
    part = make_plan(plan.buckets[1:])
    with pytest.raises(ValueError, match="every entry"):
        file_order(part.index, db.nentries)


@pytest.mark.parametrize("n1r", range(8, 113, 8))
def test_staging_holds_pack_queries_bytes(tmp_path, n1r):
    r = np.random.default_rng(n1r)
    order = int(r.integers(n1r - 7, min(n1r, 111) + 1))
    entries = [random_entry(r, 4, "e0"), random_entry(r, 6, "e1")]
    path = tmp_path / "db.ascii"
    path.write_text(format_database(entries))
    sess = SearchSession(str(path), SessionConfig(maxstart=1, device="cpu"))
    graphs = attach(sess)
    q = pack_query(random_entry(r, order, "q"))
    tag = 2 ** 32 + 2 ** 31 + n1r
    for _ in range(3):  # eager, eager and capture, replay
        sess.search(q, lsoln=False, query_tag=tag)
    g = graphs.graphs[(n1r, True, False)]
    size = query_layout(1, n1r)[1]
    want = bytes(pack_queries([q], n1r, "cpu")[0].untyped_storage())
    staging = g.staging.numpy()
    assert len(want) == size and staging.nbytes == size + 4
    assert staging[:size].tobytes() == want
    assert int(g.tag[0]) == tag & 0xFFFFFFFF
    assert g.device.numpy().tobytes() == staging.tobytes()


def test_counters_count_captures_replays_and_launches(dbfile, monkeypatch):
    real, capturing = kernel_search.sa_search, []

    def counted(*args, **kw):
        # on a card the wrapper's Python, which counts the launches, runs
        # while the graph is captured and not when it is replayed
        counted.launches += len(args[4].classes) * len(capturing)
        return real(*args, **kw)

    def capture(fn):
        capturing.append(fn)
        fn()
        capturing.pop()
        return fn

    counted.launches = counted.split_launches = 0
    monkeypatch.setattr(kernel_search, "sa_search", counted)
    sess = session(dbfile)
    attach(sess, capture)
    per = len(sess.device_db[0].classes)
    assert per == 2
    names = ["e0", "e1", "e0", "e0", "e6", "e1", "e7", "e0"]
    # keys (n1r): 8, 8, 8, 8, 56, 8, 72, 8: 3 first searches and one
    # second (eager; the second captures), 4 replays
    replays = kernel_search.graph_replays
    captures = kernel_search.graph_captures
    for name in names:
        sess.search(sess.resolve_query(name), query_tag=0)
    assert kernel_search.graph_captures - captures == 1
    assert kernel_search.graph_replays - replays == len(names) - 4
    assert counted.launches == per * (len(names) - 4)
    assert counted.split_launches == 0  # r_seq 1: nothing to split


def test_distances_off_the_bf16_grid_are_refused_on_the_graph_path(dbfile):
    sess = session(dbfile)
    attach(sess)
    good = sess.resolve_query("e1")
    bad = sess.resolve_query("e0")
    bad.dmat[0, 1] = np.float32(3.14159)
    with pytest.raises(ValueError, match="bf16 grid"):
        sess.search(bad)  # eager
    for _ in range(2):
        sess.search(good)  # eager; the second captures the key's graph
    assert (8, True, True) in sess.graphs.graphs
    replays = kernel_search.graph_replays
    with pytest.raises(ValueError, match="bf16 grid"):
        sess.search(bad)  # the graph path
    assert kernel_search.graph_replays == replays
    ref = session(dbfile).search(good, query_tag=4)
    np.testing.assert_array_equal(sess.search(good, query_tag=4).scores,
                                  ref.scores)


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
        trace.clear()
        sess.search(q, lsoln=lsoln, query_tag=6)  # replays
        sess.search(q, lsoln=lsoln, query_tag=7)
    spans = trace.spans()
    assert [s.name for s in spans] == 2 * [s.name for s in eager]
    for first, s in zip(eager + eager, spans):
        assert (s.parent >= 0) == (first.parent >= 0)
        assert s.nbytes == first.nbytes
    by = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "kernel_search.enqueue":
            assert by[s.parent].name == "kernel_search.launch_group"
            assert (s.tag, s.queries) == (by[s.parent].tag, 1)
        if s.name == "kernel_search.drain":
            assert by[s.parent].name == "session.search"
            assert s.nbytes == 4 * E * (1 + (n1r if lsoln else 0))
    assert [s.tag for s in spans if s.name == "session.search"] == [6, 7]
