"""The port's load-balance accounting (ops/balance.py), its graft entry
points (graft_entry.py) and its latency budget (latency_budget.py), on
the CPU.  Per-shard work must be equal exactly (imbalance 0); the naive
contiguous split must give the JAX package's numbers under the same
rates (to 1e-12, relative); the entry points' sharded searches must
equal the unsharded ones bitwise."""

import io
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu.io.pack import (  # noqa: E402
    pack_database as jpack_database)
from cuda_satabsearch_tpu.ops import balance as jbalance  # noqa: E402
from cuda_satabsearch_tpu_torch import graft_entry, latency_budget  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import (  # noqa: E402
    pack_database, pack_query)
from cuda_satabsearch_tpu_torch.ops import balance  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    search_db, upload_db)
from cuda_satabsearch_tpu_torch.synthetic import astral_entries  # noqa: E402


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads: the suite's other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def entries():
    return astral_entries(700, seed=4)


@pytest.mark.parametrize("ndev", range(1, 9))
def test_every_shard_has_equal_work(entries, ndev):
    db = pack_database(entries, pad_to=ndev)
    rep = balance.balance_report(db, ndev)
    assert rep["ndev"] == ndev
    assert rep["imbalance"] == 0.0
    assert len(set(rep["per_shard_ms"])) == 1
    assert len(set(rep["iters_m_per_shard"])) == 1
    assert rep["padding_overhead"] > 0.0
    if ndev > 1:
        assert rep["naive_imbalance"] > 0.0


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_naive_split_equals_jax(entries, ndev, monkeypatch):
    """The JAX package's report under the port's H100 rates: the naive
    contiguous split's per-shard work and imbalance are the same (the
    chunk-split numbers differ by design: the TPU chunk plan pads)."""
    monkeypatch.setattr(jbalance, "RATE_M_IT_S", dict(balance.RATE_M_IT_S))
    rep = balance.balance_report(pack_database(entries, pad_to=ndev), ndev)
    ref = jbalance.balance_report(jpack_database(entries, pad_to=ndev), ndev)
    assert rep["per_shard_naive_ms"] == ref["per_shard_naive_ms"]
    assert rep["naive_imbalance"] == pytest.approx(ref["naive_imbalance"],
                                                   rel=1e-12, abs=1e-12)
    for d in (8, 12, 20, 40, 96, 111, 112):
        assert balance.rate(d) == jbalance._rate(d)


def test_report_text_and_rate_table():
    rep = {"ndev": 2, "per_shard_ms": [1.25, 1.25], "imbalance": 0.0,
           "naive_imbalance": 0.5, "padding_overhead": 0.125}
    assert balance.format_report(rep) == jbalance.format_report(rep)
    assert sorted(balance.RATE_M_IT_S) == [8, 16, 24, 32, 48, 64, 80, 112]
    assert balance.RATE_M_IT_S != jbalance.RATE_M_IT_S  # no TPU rate


def test_unassigned_entry_raises(entries):
    """An entry that no bucket holds is an error, not garbage."""
    db = pack_database(entries[:50], pad_to=2)
    db.buckets[0].index[0] = -1
    with pytest.raises(ValueError, match="in no bucket"):
        balance.balance_report(db, 2)
    with pytest.raises(ValueError, match="pad_to=3"):
        balance.balance_report(pack_database(entries[:50], pad_to=2), 3)


def test_graft_entry_runs_on_cpu():
    """entry(device="cpu"): the plain version of one launch plan's
    search, equal to search_db on the same DB."""
    fn, args = graft_entry.entry(device="cpu")
    scores, maps = fn(*args)
    entries = graft_entry.synthetic_entries(4, np.random.default_rng(0))
    assert scores.shape == (1, 4) and maps.shape == (1, 4, 16)
    db = pack_database(entries)
    ref = search_db(pack_query(entries[0]), db, upload_db(db, "cpu"),
                    maxstart=graft_entry.MAXSTART, seed=graft_entry.SEED,
                    c_max=graft_entry.MAXSTART, backend="torch", query_tag=0)
    order = args[-1].index
    np.testing.assert_array_equal(scores[0].numpy(), ref.scores[order])
    np.testing.assert_array_equal(maps[0, :, :entries[0].order].numpy(),
                                  ref.ssemaps[order])


def test_graft_entry_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_cpu(n, capsys):
    rep = graft_entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip: OK on {n} shards" in out
    assert out.count("ASTRAL-mix(2048) mesh balance") == 1
    assert rep["ndev"] == n and rep["imbalance"] == 0.0


def test_latency_budget_cpu():
    """-c drives the whole script: a line per span of the search path,
    each the median self time from the program's spans, then the whole
    query, which is no less than the spans' self times together."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = latency_budget.main(["-c", "--restarts", "2", "--reps", "1"])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and len(lines) == 7
    assert "on cpu (586-entry DB" in lines[0] and "over 1 queries" in lines[0]
    names = [ln.split()[0] for ln in lines[1:6]]
    assert names == ["session.search", "kernel_search.launch_group",
                     "kernel_search.enqueue", "kernel_search.drain",
                     "stats.score_stats"]
    ms = [float(ln.split()[-2]) for ln in lines[1:]]
    assert all(ln.endswith(" ms") for ln in lines[1:])
    assert all(v > 0 for v in ms)
    assert lines[6].split()[:2] == ["whole", "query"]
    assert ms[-1] >= sum(ms[:-1]) - 1e-3  # rounding of the printed values
