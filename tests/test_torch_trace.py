"""The port's spans (cuda_satabsearch_tpu_torch/trace.py) and
the benchmark's reader of them (satbench/program_spans.py), on the CPU.

* Recording is off by default, on inside ``trace.recording()`` and on
  while a ``torch.profiler`` profile runs; the profiler's flag is read,
  so a torch that stops setting it fails here.
* A ``-c`` ``search_many`` records the expected tree: names, parents,
  request ids, one ``kernel_search.enqueue`` per query tile.
* A ``kernel_search.drain`` span carries the bytes of the drained
  arrays, with and without LSOLN, gathered or not.
* The bounded buffer counts the spans it drops, and ``program_spans``
  reads nothing from a record that dropped spans.
* ``program_spans`` and the seven metric readers on hand-built spans and
  device intervals, including spans that cross the window's edges.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch import trace  # noqa: E402
from cuda_satabsearch_tpu_torch.io.writer import format_database  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import kernel_search  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.search import Searcher  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)
from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats  # noqa: E402
from satbench import program_spans  # noqa: E402
from satbench.cells import metric_reader  # noqa: E402
from satbench.trace import TraceSummary  # noqa: E402

from conftest import random_entry  # noqa: E402

ORDERS = [3, 5, 7, 8, 12, 14]  # round8 groups 8 and 16


@pytest.fixture(autouse=True)
def fresh_trace():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dbfile(tmp_path_factory):
    rng = np.random.default_rng(11)
    entries = [random_entry(rng, n, f"e{i}") for i, n in enumerate(ORDERS)]
    path = tmp_path_factory.mktemp("db") / "db.ascii"
    path.write_text(format_database(entries))
    return str(path)


@pytest.fixture(scope="module")
def session(dbfile):
    return SearchSession(dbfile, SessionConfig(maxstart=2, device="cpu"))


def test_off_by_default_records_nothing(session):
    assert trace.begin("x") is None
    trace.end(None)
    q = session.resolve_query("e0")
    session.search(q, lsoln=False)
    assert trace.spans() == [] and trace.dropped() == 0


def test_recording_is_on_inside_recording_only():
    with trace.recording():
        trace.end(trace.begin("inside", 4, 2))
    trace.end(trace.begin("after"))
    (s,) = trace.spans()
    assert (s.name, s.parent, s.tag, s.queries) == ("inside", -1, 4, 2)
    assert 0 < s.start_ns <= s.end_ns


def test_a_profile_turns_recording_on_and_off(session):
    from torch.profiler import ProfilerActivity, profile

    q = session.resolve_query("e1")
    trace.end(trace.begin("before"))
    with profile(activities=[ProfilerActivity.CPU]):
        trace.end(trace.begin("inside"))
        session.search(q, lsoln=False)
    trace.end(trace.begin("after"))
    names = [s.name for s in trace.spans()]
    assert names[0] == "inside" and "before" not in names
    assert "after" not in names
    assert {"session.search", "kernel_search.launch_group",
            "kernel_search.enqueue", "kernel_search.drain"} <= set(names)


def test_search_many_records_the_span_tree(session, monkeypatch):
    """Five queries of round8 group 8 (two tiles of three) and two of
    group 16 (one tile), resolved by name, searched, and scored."""
    monkeypatch.setattr(kernel_search, "K_TILE", 3)
    names = ["e0", "e1", "e2", "e3", "e0", "e4", "e5"]
    with trace.recording():
        qs = [session.resolve_query(n) for n in names]
        first = session._query_tag
        results = session.search_many(qs, lsoln=False)
        for q, r in zip(qs, results):
            score_stats(r.scores, q.order, r.orders)
    spans = trace.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert sorted(by) == ["kernel_search.drain", "kernel_search.enqueue",
                          "kernel_search.launch_group",
                          "session.resolve_query", "session.search_many",
                          "stats.score_stats"]
    # resolve and stats: one root span each, each its own request
    roots = [s for s in spans if s.parent == -1]
    assert len(by["session.resolve_query"]) == 7
    assert len(by["stats.score_stats"]) == 7
    assert len(roots) == 15 and len({s.request for s in roots}) == 15
    (top,) = by["session.search_many"]
    assert top.parent == -1 and (top.tag, top.queries) == (first, 7)
    # launch_group per round8 group, drain once, all children of the call
    groups = sorted(by["kernel_search.launch_group"], key=lambda s: s.sid)
    assert [(g.tag, g.queries) for g in groups] == [(first, 5),
                                                   (first + 5, 2)]
    (dr,) = by["kernel_search.drain"]
    for s in groups + [dr]:
        assert s.parent == top.sid and s.request == top.request
    assert dr.start_ns >= max(g.end_ns for g in groups)
    # one enqueue per tile, inside its group
    enq = sorted(by["kernel_search.enqueue"], key=lambda s: s.sid)
    assert [(e.parent, e.tag, e.queries) for e in enq] == [
        (groups[0].sid, first, 3), (groups[0].sid, first + 3, 2),
        (groups[1].sid, first + 5, 2)]
    for e in enq:
        assert e.request == top.request
        g = next(g for g in groups if g.sid == e.parent)
        assert g.start_ns <= e.start_ns <= e.end_ns <= g.end_ns


def test_search_records_its_tag_and_one_query(session):
    q = session.resolve_query("e4")
    with trace.recording():
        session.search(q, lsoln=True, query_tag=77)
    top = [s for s in trace.spans() if s.name == "session.search"]
    assert [(s.tag, s.queries, s.parent) for s in top] == [(77, 1, -1)]
    assert {s.request for s in trace.spans()} == {top[0].request}


@pytest.mark.parametrize("lsoln", [False, True])
@pytest.mark.parametrize("gather", [False, True])
def test_d2h_bytes_counts_the_drained_arrays(session, lsoln, gather):
    groups = [[session.resolve_query(n) for n in names]
              for names in (["e0", "e2", "e3"], ["e4", "e5"])]
    searcher = Searcher(session.db, session.device_db, maxstart=2, c_max=2,
                        seed=5, backend="torch", gather=gather)
    launched = [searcher.launch(qs, list(range(len(qs))), lorder=True,
                                lsoln=lsoln)
                for qs in groups]
    want = sum(s.nbytes + (m.nbytes if lsoln else 0)
               for g in launched for step in g.steps for s, m in [step.out])
    E = session.nentries
    assert want == 4 * E * sum(len(qs) * (1 + (8 if lsoln else 0)
                                          * (1 if qs[0].order <= 8 else 2))
                               for qs in groups)
    with trace.recording():
        searcher.drain(launched)
    (span,) = trace.spans()
    assert (span.name, span.nbytes) == ("kernel_search.drain", want)
    searcher.drain(launched)  # nothing recorded when off
    assert trace.spans() == [span]


def test_the_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "BOUND", 3)
    with trace.recording():
        outer = trace.begin("outer")
        for i in range(4):
            trace.end(trace.begin("inner", i, 1))
        trace.end(outer)
    assert [s.tag for s in trace.spans()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_program_spans_read_nothing_from_a_truncated_record(monkeypatch):
    monkeypatch.setattr(trace, "BOUND", 2)
    with trace.recording():
        for i in range(3):
            trace.end(trace.begin("stats.score_stats", i, 1))
    lo, hi = trace.spans()[0].start_ns, trace.spans()[-1].end_ns + 1
    run = types.SimpleNamespace(
        trace=TraceSummary(window_ns=(lo, hi), device=[]),
        window=types.SimpleNamespace(queries=3))
    assert trace.dropped() == 1
    assert program_spans.recorded(run) is None
    assert program_spans.total_ns(run, "stats.score_stats") is None
    assert metric_reader("stats_ms_per_query.survey")(run) is None
    trace.clear()  # a whole record again reads its spans
    with trace.recording():
        trace.end(trace.begin("stats.score_stats", 0, 1))
    run.trace = TraceSummary(window_ns=(trace.spans()[0].start_ns - 1,
                                        trace.spans()[0].end_ns + 1),
                             device=[])
    assert program_spans.total_ns(run, "stats.score_stats") is not None


def test_spans_close_when_the_search_raises(session, monkeypatch):
    def fail(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(kernel_search, "search_plan_plain", fail)
    q = session.resolve_query("e0")
    with trace.recording():
        with pytest.raises(RuntimeError, match="launch failed"):
            session.search_many([q])
        trace.end(trace.begin("next"))
    names = [(s.name, s.parent == -1) for s in trace.spans()]
    assert names == [("kernel_search.enqueue", False),
                     ("kernel_search.launch_group", False),
                     ("session.search_many", True), ("next", True)]


# ------------------------------------------------ satbench/program_spans.py

def S(name, a, b, sid, parent=-1, nbytes=0):
    return trace.Span(name, a, b, sid, parent, 0, -1, 0, nbytes)


# window [100, 1000); device busy [120, 300) and [960, 980)
SPANS = [
    S("kernel_search.drain", 20, 90, 10, nbytes=1000),  # before the window
    S("kernel_search.drain", 80, 110, 11, nbytes=7),  # crosses its start
    S("session.search", 50, 400, 0),
    S("kernel_search.launch_group", 60, 150, 1, parent=0),
    S("kernel_search.enqueue", 100, 140, 3, parent=1),
    S("kernel_search.drain", 200, 380, 2, parent=0, nbytes=32),
    S("session.search", 900, 1100, 4),  # crosses its end
    S("kernel_search.drain", 950, 1050, 5, parent=4, nbytes=64),
    S("session.resolve_query", 410, 430, 6),
    S("stats.score_stats", 440, 445, 7),
    S("stats.score_stats", 990, 1200, 8),
]
DEVICE = [(120, 250, "sa_plan_kernel<1, 1>"), (240, 300, "Memcpy DtoH"),
          (960, 980, "sa_plan_kernel<4, 1>")]


def _run(spans=SPANS, traced=True, queries=4):
    tr = (TraceSummary(window_ns=(100, 1000), device=DEVICE)
          if traced else None)
    run = types.SimpleNamespace(trace=tr,
                                window=types.SimpleNamespace(queries=queries))
    return run, spans


@pytest.fixture
def fake_spans(monkeypatch):
    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


def test_program_spans_clip_to_the_window(fake_spans):
    run, spans = _run()
    fake_spans(spans)
    assert len(program_spans.recorded(run)) == len(spans) - 1
    # [100, 400) and [900, 1000)
    assert program_spans.total_ns(run, "session.search") == 400
    # 300 less launch_group [100, 150) and drain [200, 380); 100 less
    # the drain's [950, 1000)
    assert program_spans.self_ns(run, "session.search") == 70 + 50
    assert program_spans.self_ns(run, "kernel_search.launch_group") == 10
    # drains [100, 110), [200, 380), [950, 1000) less busy [200, 300)
    # and [960, 980)
    assert program_spans.idle_ns(run, "kernel_search.drain") == 10 + 80 + 30
    assert program_spans.total_ns(run, "kernel_search.drain") == 240
    assert program_spans.nbytes(run, "kernel_search.drain") == 96
    assert program_spans.total_ns(run, "stats.score_stats") == 15
    assert program_spans.total_ns(run, "no.such") == 0


def test_program_spans_merge_the_device_busy_intervals():
    assert program_spans.merged([(5, 9), (1, 3), (2, 4), (9, 9), (9, 12)]) \
        == [[1, 4], [5, 12]]


@pytest.mark.parametrize("case", ["untraced", "no spans", "outside"])
def test_program_spans_read_nothing_without_spans(fake_spans, case):
    run, spans = _run(traced=case != "untraced",
                      spans={"no spans": [],
                             "outside": [S("session.search", 1, 50, 0)]}.get(
                                 case, SPANS))
    fake_spans(spans)
    assert program_spans.recorded(run) is None
    for f in (program_spans.total_ns, program_spans.self_ns,
              program_spans.idle_ns, program_spans.nbytes):
        assert f(run, "session.search") is None


METRICS = {
    "resolve_ms_per_query.survey": 20 / 4e6,
    "stats_ms_per_query.survey": 15 / 4e6,
    "launch_host_ms_per_query.interactive": 10 / 4e6,
    "enqueue_ms_per_query.interactive": 40 / 4e6,
    "drain_idle_ms_per_query.interactive": 120 / 4e6,
    "search_self_ms_per_query.interactive": 120 / 4e6,
    "d2h_bytes_per_query.interactive": 96 / 4,
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metric_readers(fake_spans, name):
    read = metric_reader(name)
    run, spans = _run()
    fake_spans(spans)
    assert read(run) == pytest.approx(METRICS[name], rel=1e-12)
    assert read(_run(queries=0)[0]) is None
    assert read(_run(traced=False)[0]) is None
    fake_spans([])
    assert read(run) is None
