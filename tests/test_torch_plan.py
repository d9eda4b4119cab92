"""The port's launch plan (cuda_satabsearch_tpu_torch/ops/kernel_search.py
``make_plan``) and its plain version (ops/engine.py
``search_plan_plain``): every entry of a shard in exactly one of at most
two launch classes, split at d2 32 / 48 and widest first; one plan per
shard of a mesh; the plain plan with (seed, tags, index) equal, bitwise,
to the per-bucket plain search on ``rng.entry_keys`` and to the JAX
package's ``search_db`` on its XLA engine; the kernel's wrapper running
the plain version on CPU tensors without counting a launch.  The CUDA
kernel itself is held against the plain plan on the card by
chip_smoke.py (phases 1-2)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cuda_satabsearch_tpu.io.pack import pack_database as jpack_database  # noqa: E402
from cuda_satabsearch_tpu.io.pack import pack_query as jpack_query  # noqa: E402
from cuda_satabsearch_tpu.io.parser import (  # noqa: E402
    parse_search_input as jparse_search_input, read_database as jread_database)
from cuda_satabsearch_tpu.ops.search import search_db as jsearch_db  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import (  # noqa: E402
    DEFAULT_BUCKETS, pack_database, pack_query)
from cuda_satabsearch_tpu_torch.io.parser import (  # noqa: E402
    parse_search_input, read_database)
from cuda_satabsearch_tpu_torch.ops import rng  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.common import slots_per_restart  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.engine import (  # noqa: E402
    search_plain, search_plan_plain)
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    NARROW_MAX, make_plan, pack_queries, prepare_bucket)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (  # noqa: E402
    sa_search, upload_tags)
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    search_db, upload_db)
from cuda_satabsearch_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

from conftest import random_entry  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DB586 = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")


def _every_width_db(seed, pad_to=1, per=2):
    """Entries in every bucket of DEFAULT_BUCKETS (orders at each cap and
    just above the cap below), padded to ``pad_to`` rows per bucket."""
    r = np.random.default_rng(seed)
    lows = (2,) + tuple(c + 1 for c in DEFAULT_BUCKETS[:-1])
    orders = [int(r.integers(lo, min(cap, 111) + 1))
              for lo, cap in zip(lows, DEFAULT_BUCKETS) for _ in range(per)]
    r.shuffle(orders)
    entries = [random_entry(r, o, f"e{i:03d}") for i, o in enumerate(orders)]
    return pack_database(entries, pad_to=pad_to), entries


def _columns(plan):
    """Each launch class's output columns, as one sorted list per class."""
    return [sorted(c for b, out in cls.buckets
                   for c in range(out, out + len(b.index)))
            for cls in plan.classes]


@pytest.mark.parametrize("pad_to", [1, 3])
def test_plan_puts_every_entry_in_exactly_one_class(pad_to):
    db, entries = _every_width_db(1, pad_to)
    (plan,) = upload_db(db, "cpu")
    assert plan.nentries == sum(b.size for b in db.buckets)
    cols = [c for cls in _columns(plan) for c in cls]
    assert sorted(cols) == list(range(plan.nentries))  # each exactly once
    np.testing.assert_array_equal(
        plan.index, np.concatenate([b.index for b in db.buckets]))
    valid = plan.index[plan.index >= 0]
    assert sorted(valid) == list(range(len(entries)))
    assert (plan.index < 0).sum() == (0 if pad_to == 1 else
                                      sum(b.size for b in db.buckets)
                                      - len(entries))
    for cls in plan.classes:  # each bucket's columns, in output order
        for b, out in cls.buckets:
            np.testing.assert_array_equal(
                plan.index[out:out + len(b.index)], b.index)


@pytest.mark.parametrize("dims", [DEFAULT_BUCKETS, (8, 16, 24, 32),
                                  (48, 64, 80, 112), (8, 112), (32, 48)])
def test_plan_splits_at_32_48_widest_first(dims):
    db, _ = _every_width_db(2)
    buckets = [prepare_bucket(b, "cpu") for b in db.buckets if b.dim in dims]
    plan = make_plan(buckets)
    wide = [b.dim for b in buckets if b.dim > NARROW_MAX]
    narrow = [b.dim for b in buckets if b.dim <= NARROW_MAX]
    got = [[b.dim for b, _ in cls.buckets] for cls in plan.classes]
    assert got == [sorted(d, reverse=True) for d in (wide, narrow) if d]
    assert all(min(g) >= 48 for g in got[:1] if wide)
    assert all(max(g) <= 32 for g in got[len(got) - 1:] if narrow)
    assert [cls.d2max for cls in plan.classes] == [g[0] for g in got]
    assert [b.dim for b in plan.buckets] == list(dims)  # output order
    assert NARROW_MAX == 32


def test_plan_of_no_buckets_and_too_many():
    plan = make_plan([], "cpu")
    assert plan.nentries == 0 and plan.classes == []
    db, _ = _every_width_db(3, per=1)
    b = prepare_bucket(db.buckets[0], "cpu")
    with pytest.raises(ValueError, match="one launch class"):
        make_plan([b] * 9)


@pytest.mark.parametrize("ndev", [2, 3])
def test_every_shard_of_a_mesh_gets_its_own_plan(ndev):
    db, _ = _every_width_db(4, pad_to=ndev)
    plans = upload_db(db, make_mesh(["cpu"] * ndev))
    assert len(plans) == ndev
    assert len({id(p) for p in plans}) == ndev
    for i, plan in enumerate(plans):
        assert [b.dim for b in plan.buckets] == [b.dim for b in db.buckets]
        expect = np.concatenate([
            b.index[i * (b.size // ndev):(i + 1) * (b.size // ndev)]
            for b in db.buckets])
        np.testing.assert_array_equal(plan.index, expect)
        assert sorted(c for cls in _columns(plan) for c in cls) == list(
            range(plan.nentries))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([p.index for p in plans])),
        np.sort(np.concatenate([b.index for b in db.buckets])))


def _queries(seed, orders):
    r = np.random.default_rng(seed)
    return [pack_query(random_entry(r, n, f"q{k}"))
            for k, n in enumerate(orders)]


@pytest.mark.parametrize("lorder,lsoln,orders,c_par,r_seq", [
    (True, True, [9, 13, 16], 16, 1),
    (False, True, [5], 8, 2),
    (True, False, [21, 24], 12, 1),
])
def test_plain_plan_equals_per_bucket_plain_on_entry_keys(lorder, lsoln,
                                                          orders, c_par,
                                                          r_seq):
    db, _ = _every_width_db(5, pad_to=2, per=1)
    (plan,) = upload_db(db, "cpu")
    queries = _queries(6, orders)
    q = pack_queries(queries, max(8, -(-max(orders) // 8) * 8), "cpu")
    tags = [7, 0, 2 ** 33 + 5][:len(orders)]
    kw = dict(c_par=c_par, r_seq=r_seq, lorder=lorder, lsoln=lsoln)
    got = search_plan_plain(*q, plan, seed=99, tags=tags, **kw)
    refs = [search_plain(*q, b.types, b.tab, b.dmat, b.n2,
                         keys=rng.entry_keys(99, tags, b.index), **kw)
            for b in plan.buckets]
    np.testing.assert_array_equal(
        got[0].numpy(), np.concatenate([r[0].numpy() for r in refs], 1))
    if lsoln:
        np.testing.assert_array_equal(
            got[1].numpy(), np.concatenate([r[1].numpy() for r in refs], 1))
    else:
        assert got[1] is None
    # the kernel's int32 tags (uint32 bits) give the same keys
    again = search_plan_plain(*q, plan, seed=99,
                              tags=upload_tags(tags, "cpu"), **kw)
    np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())


def test_plain_plan_supplied_stream_is_cut_per_bucket():
    db, _ = _every_width_db(7, per=1)
    (plan,) = upload_db(db, "cpu")
    (query,) = _queries(8, [6])
    q = pack_queries([query], 8, "cpu")
    P = slots_per_restart(8)
    u = torch.from_numpy(np.random.default_rng(9).random(
        (1, plan.nentries, 1, P, 8), dtype=np.float32))
    u = rng.log_acc_slots(u, 8)
    kw = dict(c_par=8, r_seq=1, lorder=True, lsoln=True)
    got = search_plan_plain(*q, plan, uniforms=u, **kw)
    off = 0
    for b in plan.buckets:
        E = len(b.index)
        s, m = search_plain(*q, b.types, b.tab, b.dmat, b.n2,
                            uniforms=u[:, off:off + E], **kw)
        np.testing.assert_array_equal(got[0][:, off:off + E].numpy(),
                                      s.numpy())
        np.testing.assert_array_equal(got[1][:, off:off + E].numpy(),
                                      m.numpy())
        off += E
    with pytest.raises(ValueError, match="exactly one"):
        search_plan_plain(*q, plan, **kw)


def _fixture_subset():
    """Entries of the 586-entry fixture DB: the first three of each
    bucket (every bucket width the DB holds), in file order."""
    entries = read_database(DB586)
    caps = [next(c for c in DEFAULT_BUCKETS if e.order <= c)
            for e in entries]
    keep = sorted(i for cap in set(caps)
                  for i in [j for j, c in enumerate(caps) if c == cap][:3])
    return keep


@pytest.mark.parametrize("lsoln,qfile", [(True, "d1ubia_.input"),
                                         (False, "d2phlb1.input")])
def test_plain_plan_equals_jax_search_db(lsoln, qfile):
    """The port's search (plan, plain engine on the CPU, keys from
    (seed, tag, index)) == the JAX package's search_db on its XLA engine,
    bitwise, on entries of the 586-entry fixture DB."""
    keep = _fixture_subset()
    jentries = [jread_database(DB586)[i] for i in keep]
    entries = [read_database(DB586)[i] for i in keep]
    with open(os.path.join(FIXTURES, qfile)) as fp:
        jq = jpack_query(jparse_search_input(fp).queries[0])
    with open(os.path.join(FIXTURES, qfile)) as fp:
        query = pack_query(parse_search_input(fp).queries[0])
    jdb, db = jpack_database(jentries), pack_database(entries)
    assert len({b.dim for b in db.buckets}) >= 6
    ref = jsearch_db(jq, jdb, maxstart=8, seed=1234, query_tag=2,
                     backend="xla", lsoln=lsoln)
    got = search_db(query, db, upload_db(db, "cpu"), maxstart=8, seed=1234,
                    query_tag=2, backend="torch", lsoln=lsoln)
    np.testing.assert_array_equal(got.scores, ref.scores)
    if lsoln:
        np.testing.assert_array_equal(got.ssemaps, ref.ssemaps)


def test_wrapper_runs_plain_plan_on_cpu_without_counting_a_launch():
    db, _ = _every_width_db(10, pad_to=2, per=1)
    (plan,) = upload_db(db, "cpu")
    q = pack_queries(_queries(11, [5, 7]), 8, "cpu")
    kw = dict(seed=3, tags=[0, 1], c_par=8, r_seq=2, lorder=True,
              lsoln=True)
    before = sa_search.launches
    got = sa_search(*q, plan, **kw)
    assert sa_search.launches == before
    ref = search_plan_plain(*q, plan, **kw)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_refuses_a_plan_on_other_devices():
    q = tuple(t.to("meta") for t in pack_queries(_queries(12, [5]), 8, "cpu"))
    with pytest.raises(ValueError, match="no SA kernel"):
        sa_search(*q, make_plan([], "meta"), tags=[0], c_par=8, r_seq=1,
                  lorder=True, lsoln=False)


def test_queries_upload_as_one_buffer():
    queries = _queries(13, [9, 16, 11])
    qtypes, qtab, qdmat, n1s = pack_queries(queries, 16, "cpu")
    assert (qtypes.dtype, qtab.dtype, qdmat.dtype, n1s.dtype) == (
        torch.int8, torch.uint8, torch.float32, torch.int32)
    assert tuple(qdmat.shape) == (3, 16, 16) and n1s.tolist() == [9, 16, 11]
    base = qtypes.untyped_storage().data_ptr()
    for t in (qtab, qdmat, n1s):
        assert t.untyped_storage().data_ptr() == base
        assert (t.data_ptr() - base) % 256 == 0
    for k, q in enumerate(queries):
        np.testing.assert_array_equal(qdmat[k, :q.order, :q.order].numpy(),
                                      q.dmat)
        np.testing.assert_array_equal(qtypes[k, :q.order].numpy(), q.types)


def test_distances_off_the_bf16_grid_are_refused():
    db, _ = _every_width_db(14, per=1)
    b = db.buckets[0]
    b.dmat[0, 0, 1] = np.float32(1.0001)
    with pytest.raises(ValueError, match="bf16 grid"):
        prepare_bucket(b, "cpu")
    (query,) = _queries(15, [5])
    query.dmat[0, 1] = np.float32(3.14159)
    with pytest.raises(ValueError, match="bf16 grid"):
        pack_queries([query], 8, "cpu")


def test_tags_upload_as_uint32_bits():
    t = upload_tags([0, 5, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3, -1], "cpu")
    assert t.dtype == torch.int32
    assert (t.numpy().view(np.uint32).tolist()
            == [0, 5, 2 ** 31, 2 ** 32 - 1, 3, 2 ** 32 - 1])
