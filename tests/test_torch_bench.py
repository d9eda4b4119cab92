"""The port's benchmark runner (cuda_satabsearch_tpu_torch/bench.py)
against the root bench.py (the JAX package's), on the CPU.

* ``synthetic.astral_entries`` is bitwise the root bench's
  ``synthetic_entries``;
* ``run_search`` on the plain engine gives the scores and maps of the
  JAX package's XLA engine at the same seed and tags (tags 0-4 for the
  single searches, then the stream's);
* ``main(["-c", ...])`` prints one JSON line with exactly the root
  bench's keys;
* ``--paritycheck`` writes only to ``--out``, never to the root
  PARITY.json, and needs a card; so does the benchmark without ``-c``.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import bench as jbench  # noqa: E402
from cuda_satabsearch_tpu.io.pack import pack_query as jpack_query  # noqa: E402
from cuda_satabsearch_tpu.io.parser import (  # noqa: E402
    parse_search_input as jparse_search_input)
from cuda_satabsearch_tpu.session import (  # noqa: E402
    SearchSession as JSearchSession, SessionConfig as JSessionConfig)
from cuda_satabsearch_tpu_torch import bench  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)
from cuda_satabsearch_tpu_torch.synthetic import astral_entries  # noqa: E402

R = 2  # restarts of every search here
NQ = 2  # queries of each sustained stream here


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads: the suite's other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_astral_entries_are_the_root_bench_generator():
    got, ref = astral_entries(300), jbench.synthetic_entries(300)
    assert len(got) == len(ref) == 300
    for g, r in zip(got, ref):
        assert (g.name, g.order) == (r.name, r.order)
        for f in ("tabhi", "tablo", "types", "dmat"):
            a, b = getattr(g, f), getattr(r, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f


def test_shapes_and_baselines_are_the_root_bench_ones():
    assert (bench.BASELINE_M_IT_S, bench.BASELINE_LARGE,
            bench.BASELINE_BIGQ, bench.REPEATS) == (
        jbench.BASELINE_M_IT_S, jbench.BASELINE_LARGE, jbench.BASELINE_BIGQ,
        jbench.REPEATS)
    assert (bench.NQ_586, bench.NQ_LARGE, bench.NQ_BIGQ,
            bench.BIGQ_RESTARTS) == (384, 64, 16, 4096)


def test_run_search_scores_equal_the_jax_package(capsys):
    """The port's run_search on the plain engine: every search's scores
    (and maps, where LSOLN is on) bitwise those of the JAX package's XLA
    engine searching the same query at the same tags."""
    path = os.path.join(bench.FIXTURES, "d1ubia_.input")
    with open(path) as fp:
        jq = jpack_query(jparse_search_input(fp).queries[0])
    sess = SearchSession(bench.DB586, SessionConfig(maxstart=R,
                                                    device="cpu"))
    calls = []
    search, search_many = sess.search, sess.search_many

    def rec_search(q, **kw):
        calls.append(("one", kw["query_tag"], search(q, **kw)))
        return calls[-1][2]

    def rec_many(qs, **kw):
        first = sess._query_tag
        res = search_many(qs, **kw)
        calls.extend(("many", first + i, r) for i, r in enumerate(res))
        return res

    sess.search, sess.search_many = rec_search, rec_many
    per_query, sustained = bench.run_search(sess, bench.read_query(
        "d1ubia_.input"), R, "586db", bench.BASELINE_M_IT_S, nq=NQ)
    assert per_query > 0 and sustained > 0
    tags = [tag for _, tag, _ in calls]
    assert tags == [0, 0, 1, 2, 3, 4] + list(range(5, 5 + 4 * NQ))
    assert "# [586db] top hits: " in capsys.readouterr().err

    jsess = JSearchSession(bench.DB586, JSessionConfig(maxstart=R,
                                                       backend="xla"))
    for kind, tag, res in calls:
        lsoln = kind == "one"  # search's default; search_many's is off
        ref = jsess.search(jq, lorder=True, query_tag=tag, lsoln=lsoln)
        np.testing.assert_array_equal(res.scores, ref.scores)
        if lsoln:
            np.testing.assert_array_equal(res.ssemaps, ref.ssemaps)


def test_main_prints_the_root_bench_keys(monkeypatch, capsys):
    """All three shapes on the plain engine at a small size: one JSON
    line on stdout with exactly the root bench's keys, each ratio its
    rate over the shape's baseline; the card line last on stderr."""
    for name, value in (("NQ_586", NQ), ("NQ_LARGE", NQ), ("NQ_BIGQ", NQ),
                        ("REPEATS", 1), ("BIGQ_RESTARTS", R)):
        monkeypatch.setattr(bench, name, value)
    rc = bench.main(["-c", "--restarts", str(R), "--large", "40"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    lines = captured.out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "per_query_m_it_s",
            "per_query_vs_baseline", "large40_m_it_s", "large40_vs_baseline",
            "bigquery_r4096_m_it_s", "bigquery_r4096_vs_baseline"}
    assert set(out) == keys
    with open(jbench.__file__) as fp:  # the root bench writes these keys
        root = fp.read()
    for key in keys - {"large40_m_it_s", "large40_vs_baseline"}:
        assert f'"{key}"' in root, key
    assert 'f"large{args.large}_m_it_s"' in root
    assert out["metric"] == "sa_search_throughput_586db_8sse_r128_sustained"
    assert out["unit"] == "M it/s"
    for rate, ratio, base in (
            ("value", "vs_baseline", bench.BASELINE_M_IT_S),
            ("per_query_m_it_s", "per_query_vs_baseline",
             bench.BASELINE_M_IT_S),
            ("large40_m_it_s", "large40_vs_baseline", bench.BASELINE_LARGE),
            ("bigquery_r4096_m_it_s", "bigquery_r4096_vs_baseline",
             bench.BASELINE_BIGQ)):
        assert out[rate] > 0
        assert out[ratio] == pytest.approx(out[rate] / base, abs=1e-4)
    err = captured.err.splitlines()
    assert err[-1].startswith("# card: none (-c")
    assert "SA kernel 0, start-up kernel 0" in err[-1]
    for label in ("586db", "large40", "d2phlb1_r4096"):
        assert any(ln.startswith(f"# [{label}] sustained ({NQ} pipelined")
                   for ln in err)


@pytest.mark.parametrize("argv,why", [
    (["--paritycheck"], "writes its artifact to --out"),
    (["--paritycheck", "--out", "PARITY.json"], "JAX package's artifact"),
    (["--paritycheck", "--out", "tests/../PARITY.json"],
     "JAX package's artifact"),
    (["--paritycheck", "--out", "{tmp}/parity.json", "-c"], "runs on a card"),
])
def test_paritycheck_refuses(argv, why, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(bench.REPO)
    with open(bench.JAX_PARITY, "rb") as fp:
        before = fp.read()
    rc = bench.main([a.format(tmp=tmp_path) for a in argv])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert re.search(f"ERROR: .*{re.escape(why)}", captured.err)
    with open(bench.JAX_PARITY, "rb") as fp:
        assert fp.read() == before
    assert not os.path.exists(tmp_path / "parity.json")


@pytest.mark.parametrize("argv", [[], ["--skip-large"],
                                  ["--paritycheck", "--out", "{tmp}/p.json"]])
def test_without_card_and_without_c_exits_1(argv, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel path would run")
    rc = bench.main([a.format(tmp=tmp_path) for a in argv])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert "ERROR: no CUDA device found" in captured.err
    assert not os.path.exists(tmp_path / "p.json")


def test_parity_gate_plumbing_on_the_cpu(monkeypatch, capsys):
    """The gate's checks run on CPU tensors too, where the wrapper runs
    the plain version: every check passes, and the batched stream is
    cut into tiles of 3 without a kernel launch."""
    monkeypatch.setattr(bench, "PARITY_ORDERS", (8,))
    checks = bench.parity_checks("cpu")
    assert len(checks) == 4 + 12 + 1 and all(ok for _, ok in checks)
    assert "5 tiles of <= 3: 0 SA launches (expected 0)" in checks[-1][0]
    assert "PARITY OK" in capsys.readouterr().err
