"""Query tiles, one drain per ``search_many`` stream, and the seed range,
on the CPU.

* ``ops/kernel_search``: a round8 group runs in tiles of at most
  ``K_TILE`` queries (one wrapper call each, at most two launches on a
  card); tiled results are bitwise the untiled ones.
* ``SearchSession.search_many`` launches every group before its one
  drain, as the JAX package dispatches every group and then assembles.
* ``ops/rng.check_seed``: seeds outside [-2**31, 2**31) raise ValueError
  in the port where the JAX package's ``entry_keys`` raises
  OverflowError; seeds inside give the JAX package's keys.
"""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu.ops.search import entry_keys as jentry_keys  # noqa: E402
from cuda_satabsearch_tpu_torch import cli  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import (  # noqa: E402
    pack_database, pack_query)
from cuda_satabsearch_tpu_torch.ops import kernel_search, rng  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    pack_queries, tiles)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (  # noqa: E402
    MAX_K, sa_search)
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    search_db_many, upload_db)
from cuda_satabsearch_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

from conftest import random_entry  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads: the suite's other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _entries(seed=1):
    """Entries in buckets 8, 16 (narrow) and 48 (wide)."""
    r = np.random.default_rng(seed)
    orders = [3, 8, 6, 12, 16, 40, 33, 5]
    return [random_entry(r, o, f"e{i}") for i, o in enumerate(orders)]


def _queries(seed, orders):
    r = np.random.default_rng(seed)
    return [pack_query(random_entry(r, o, f"q{k}"))
            for k, o in enumerate(orders)]


@pytest.mark.parametrize("K,k_tile", [(0, 64), (1, 64), (64, 64), (65, 64),
                                      (8, 3), (65536, 64)])
def test_tiles_cover_the_group_in_order(K, k_tile, monkeypatch):
    monkeypatch.setattr(kernel_search, "K_TILE", k_tile)
    got = tiles(K)
    assert [i for t in got for i in range(K)[t]] == list(range(K))
    assert all(0 < t.stop - t.start <= min(k_tile, MAX_K) for t in got)
    assert len(got) == -(-K // k_tile)


@pytest.mark.parametrize("backend,ndev", [("cuda", 1), ("torch", 1),
                                          ("cuda", 2)])
def test_query_tiles_give_the_untiled_results(backend, ndev, monkeypatch):
    """8 mixed-order queries of one round8 group in tiles of 3 against
    the same group in one tile: bitwise scores and maps, one wrapper
    call per tile and shard (on a card, one launch per launch class of
    the shard's plan)."""
    db = pack_database(_entries(), pad_to=ndev)
    shards = upload_db(db, "cpu" if ndev == 1 else make_mesh(["cpu"] * ndev))
    queries = _queries(3, [9, 16, 11, 13, 10, 16, 12, 15])
    kw = dict(lorder=True, lsoln=True, seed=77, maxstart=8, c_max=4,
              backend=backend, query_tags=[10, 11, 12, 2 ** 31 + 3, 14, 15,
                                           16, 17])
    whole = search_db_many(queries, db, shards, **kw)
    name = {"cuda": "sa_search", "torch": "search_plan_plain"}[backend]
    real, calls = getattr(kernel_search, name), []

    def record(*q, **k):
        calls.append((q[0].shape[0], k["tags"].tolist()))
        return real(*q, **k)

    monkeypatch.setattr(kernel_search, name, record)
    monkeypatch.setattr(kernel_search, "K_TILE", 3)
    tiled = search_db_many(queries, db, shards, **kw)
    assert [n for n, _ in calls] == [3, 3, 2] * len(shards)
    tags = np.array(kw["query_tags"], np.int64).astype(np.uint32).view(
        np.int32).tolist()
    assert [t for _, ts in calls[:3] for t in ts] == tags
    launches = sum(len(p.classes) for p in shards) * 3
    assert launches == 6 * ndev  # both classes in every shard
    for r0, r1, q in zip(whole, tiled, queries):
        np.testing.assert_array_equal(r1.scores, r0.scores)
        np.testing.assert_array_equal(r1.ssemaps, r0.ssemaps)
        assert r1.ssemaps.shape == (db.nentries, q.order)


def test_search_many_launches_every_group_before_its_one_drain(monkeypatch):
    """Three round8 groups: three launches (one per group), then one
    drain; each result is bitwise that of the query searched alone at
    its tag (what search_many gave when it drained group by group)."""
    sess = SearchSession("<synthetic>", SessionConfig(maxstart=4,
                                                      device="cpu"),
                         entries=_entries(2))
    queries = _queries(4, [5, 13, 20, 7, 16, 3])
    events = []
    plain, drain_many = kernel_search.search_plan_plain, sess.searcher.drain

    def launch(*a, **k):
        events.append("launch")
        return plain(*a, **k)

    def drain_once(*a, **k):
        events.append("drain")
        return drain_many(*a, **k)

    monkeypatch.setattr(kernel_search, "search_plan_plain", launch)
    monkeypatch.setattr(sess.searcher, "drain", drain_once)
    got = sess.search_many(queries, lsoln=True)
    assert events == ["launch"] * 3 + ["drain"]
    monkeypatch.undo()
    for tag, (q, g) in enumerate(zip(queries, got)):
        one = sess.search(q, lsoln=True, query_tag=tag)
        np.testing.assert_array_equal(g.scores, one.scores)
        np.testing.assert_array_equal(g.ssemaps, one.ssemaps)
        assert g.query_order == q.order


@pytest.mark.parametrize("seed", [-2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5])
def test_seed_outside_int32_is_refused(seed):
    idx = np.arange(3)
    with pytest.raises(OverflowError):
        jentry_keys(seed, 0, idx)
    with pytest.raises(ValueError, match="outside"):
        rng.entry_keys(seed, [0], idx)
    (plan,) = upload_db(pack_database(_entries()), "cpu")
    q = pack_queries(_queries(5, [6]), 8, "cpu")
    with pytest.raises(ValueError, match="outside"):
        sa_search(*q, plan, seed=seed, tags=[0], c_par=2, r_seq=1,
                  lorder=True, lsoln=False)


@pytest.mark.parametrize("seed", [-2 ** 31, -1, 0, 2 ** 31 - 1])
def test_seed_inside_int32_gives_the_jax_keys(seed):
    idx = np.array([0, 1, 585, 14290])
    for tag in (0, 7):
        got = rng.entry_keys(seed, [tag], idx)[0].numpy()
        ref = np.asarray(jentry_keys(seed, tag, idx)).astype(np.int64)
        np.testing.assert_array_equal(got, ref)
    assert rng.check_seed(seed) == seed


@pytest.mark.parametrize("seed", ["2147483648", "-2147483649"])
def test_cli_refuses_a_seed_outside_int32(seed, monkeypatch, capsys):
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        monkeypatch.setattr("sys.stdin", io.StringIO(fp.read()))
    monkeypatch.chdir(FIXTURES)
    rc = cli.main(["-c", "--seed", seed])
    captured = capsys.readouterr()
    assert rc == 1
    assert captured.out == ""
    assert f"ERROR: seed {seed} is outside" in captured.err
