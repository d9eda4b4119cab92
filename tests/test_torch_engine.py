"""The port's plain engine (cuda_satabsearch_tpu_torch/ops/engine.py)
against the JAX package's XLA engine and its Pallas kernel (interpret
mode, supplied stream, as tests/test_pallas.py runs it), fed the same
JAX-made uniform stream: scores and best maps must be bitwise equal.
Also the kernel wrapper's device dispatch.  The CUDA kernel itself is
held against the plain engine on the card by chip_smoke.py (this
directory's conftest imports jax, which the card's host lacks)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cuda_satabsearch_tpu.io.pack import (  # noqa: E402
    pack_database, pack_query)
from cuda_satabsearch_tpu.ops.common import make_uniforms  # noqa: E402
from cuda_satabsearch_tpu.ops.engine import make_bucket_search  # noqa: E402
from cuda_satabsearch_tpu.ops.search import entry_keys  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import rng  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.common import round8  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.engine import search_plain  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    make_plan, pack_queries, prepare_bucket)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search  # noqa: E402

from conftest import random_entry  # noqa: E402


def _jax_stream(seed, tags, index, r_seq, n1r, c_par):
    """f32[K, E, r_seq, P, c_par]: the JAX package's stream per tag."""
    P = n1r + 300
    return torch.from_numpy(np.stack([
        np.asarray(make_uniforms(entry_keys(seed, t, index), r_seq, P,
                                 c_par, n1r))[..., :c_par]
        for t in tags]))


def _plain(queries, bucket, *, seed, tags, c_par, r_seq, lorder,
           lsoln=True):
    n1r = round8(max(q.order for q in queries))
    b = prepare_bucket(bucket, "cpu")
    u = _jax_stream(seed, tags, bucket.index, r_seq, n1r, c_par)
    s, m = search_plain(*pack_queries(queries, n1r, "cpu"), b.types, b.tab,
                        b.dmat, b.n2, uniforms=u, c_par=c_par, r_seq=r_seq,
                        lorder=lorder, lsoln=lsoln)
    return s.numpy(), (None if m is None else m.numpy())


def _problem(seed, sizes, n1s):
    r = np.random.default_rng(seed)
    entries = [random_entry(r, int(n), f"e{i}") for i, n in enumerate(sizes)]
    queries = [pack_query(random_entry(r, n, f"q{k}"))
               for k, n in enumerate(n1s)]
    return entries, queries


@pytest.mark.parametrize("lorder,n1,d2,c_par,r_seq", [
    (True, 7, 16, 16, 2),
    (False, 7, 16, 16, 2),
    (True, 13, 24, 100, 1),
    (False, 19, 24, 128, 1),
    (True, 3, 16, 8, 2),
])
def test_plain_matches_xla_engine(lorder, n1, d2, c_par, r_seq):
    lo = 2 if d2 == 16 else 17
    entries, (query,) = _problem(
        n1 * 31 + d2, np.random.default_rng(d2).integers(lo, d2 + 1, 6),
        [n1])
    bucket = pack_database(entries, buckets=(d2, 112)).buckets[0]
    assert bucket.dim == d2
    fn = make_bucket_search(n1, d2, c_par, r_seq, lorder, "take")
    keys = entry_keys(1234, 3, bucket.index)
    es, em = fn(*(jnp.asarray(x) for x in (
        query.types, query.tabhi, query.tablo, query.dmat, bucket.types,
        bucket.tabhi, bucket.tablo, bucket.dmat, bucket.orders)), keys)
    s, m = _plain([query], bucket, seed=1234, tags=[3], c_par=c_par,
                  r_seq=r_seq, lorder=lorder)
    np.testing.assert_array_equal(s[0], np.asarray(es))
    np.testing.assert_array_equal(m[0, :, :n1], np.asarray(em))
    assert np.all(m[0, :, n1:] == -1)


@pytest.mark.parametrize("lorder,lsoln", [(True, True), (False, True),
                                          (True, False)])
def test_plain_matches_pallas_interpret(lorder, lsoln):
    """Kernel A run as the JAX tests run it (interpret, supplied
    stream), over two bucket widths."""
    from cuda_satabsearch_tpu.ops.pallas_search import (
        assemble_db_pallas2, dispatch_db_pallas2)

    entries, (query,) = _problem(41, [4, 7, 12, 16, 19, 22], [9])
    c_par, r_seq, tag = 16, 1, 2
    db = pack_database(entries, buckets=(16, 24, 112))
    ks, km = assemble_db_pallas2(dispatch_db_pallas2(
        query, db, maxstart=c_par * r_seq, lorder=lorder, seed=1234,
        query_tag=tag, c_max=c_par, interpret=True, rng_mode="supplied",
        lsoln=lsoln))
    for b in db.buckets:
        s, m = _plain([query], b, seed=1234, tags=[tag], c_par=c_par,
                      r_seq=r_seq, lorder=lorder, lsoln=lsoln)
        np.testing.assert_array_equal(s[0], ks[b.index])
        if lsoln:
            np.testing.assert_array_equal(m[0, :, :query.order],
                                          km[b.index])


def test_plain_mixed_orders_match_pallas_batched():
    """Queries of 9, 13 and 16 SSEs (one round8 group) in one call ==
    the Pallas kernel's query-batched dispatch, bitwise."""
    from cuda_satabsearch_tpu.ops.pallas_search import (
        assemble_db_pallas2_multi, dispatch_db_pallas2_multi)

    entries, queries = _problem(43, [5, 9, 14, 16, 11], [9, 13, 16])
    c_par, r_seq, tags = 16, 1, [4, 0, 7]
    db = pack_database(entries, buckets=(16, 112))
    ref = assemble_db_pallas2_multi(dispatch_db_pallas2_multi(
        queries, db, maxstart=c_par * r_seq, lorder=True, seed=1234,
        query_tags=tags, c_max=c_par, interpret=True, rng_mode="supplied",
        lsoln=True))
    b = db.buckets[0]
    s, m = _plain(queries, b, seed=1234, tags=tags, c_par=c_par,
                  r_seq=r_seq, lorder=True)
    for k, (q, (ks, km)) in enumerate(zip(queries, ref)):
        np.testing.assert_array_equal(s[k], ks[b.index])
        np.testing.assert_array_equal(m[k, :, :q.order], km[b.index])


@pytest.mark.parametrize("lsoln", [True, False])
def test_search_db_matches_xla_search_db(lsoln):
    """The port's search_db (threefry keys made by ops/rng.py, plain
    engine on the CPU, scatter to file order) == the JAX package's
    search_db on its XLA engine, bitwise.  The two packages' ln u may
    differ by 1 ulp (ops/rng.ln_f32), which flips no decision here."""
    from cuda_satabsearch_tpu.ops.search import search_db as jsearch_db
    from cuda_satabsearch_tpu_torch.ops.search import search_db, upload_db

    entries, (query,) = _problem(47, [3, 8, 9, 15, 16, 20, 30, 5], [8])
    db = pack_database(entries)
    ref = jsearch_db(query, db, maxstart=32, seed=5, query_tag=6,
                     backend="xla", lsoln=lsoln)
    got = search_db(query, db, upload_db(db, "cpu"), maxstart=32, seed=5,
                    query_tag=6, backend="torch", lsoln=lsoln)
    np.testing.assert_array_equal(got.scores, ref.scores)
    if lsoln:
        np.testing.assert_array_equal(got.ssemaps, ref.ssemaps)
    else:
        assert got.ssemaps is None
    assert got.names == ref.names


def _small_call(device):
    entries, queries = _problem(53, [4, 6, 8], [5, 7])
    b = prepare_bucket(pack_database(entries, buckets=(8, 112)).buckets[0],
                       device)
    q = pack_queries(queries, 8, device)
    keys = rng.entry_keys(1234, [0, 1], b.index, device=device)
    return q, b, keys


def test_wrapper_runs_plain_on_cpu_without_launching():
    """The wrapper on a one-bucket plan with the seeded stream (seed,
    tags, file-order index) == the plain engine on the same keys."""
    q, b, keys = _small_call("cpu")
    kw = dict(c_par=16, r_seq=2, lorder=True, lsoln=True)
    before = sa_search.launches
    got = sa_search(*q, make_plan([b]), seed=1234, tags=[0, 1], **kw)
    ref = search_plain(*q, b.types, b.tab, b.dmat, b.n2, keys=keys, **kw)
    assert sa_search.launches == before
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_refuses_other_devices():
    q = tuple(t.to("meta") for t in _small_call("cpu")[0])
    with pytest.raises(ValueError, match="no SA kernel"):
        sa_search(*q, make_plan([], "meta"), seed=1234, tags=[0, 1],
                  c_par=8, r_seq=1, lorder=True, lsoln=False)


def test_plain_needs_exactly_one_stream():
    q, b, keys = _small_call("cpu")
    with pytest.raises(ValueError, match="exactly one"):
        search_plain(*q, b.types, b.tab, b.dmat, b.n2, c_par=8, r_seq=1,
                     lorder=True, lsoln=False)
