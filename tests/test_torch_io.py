"""The port's copies of the jax-free modules against the originals:
parser, packer (bf16 quantization through torch instead of ml_dtypes),
query layout helpers, score statistics and the result formatter, on
every fixture DB and query file.  All comparisons are bitwise or
byte-exact."""

import glob
import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu.io import pack as jpack  # noqa: E402
from cuda_satabsearch_tpu.io import parser as jparser  # noqa: E402
from cuda_satabsearch_tpu.ops import common as jcommon  # noqa: E402
from cuda_satabsearch_tpu.ops.search import (  # noqa: E402
    SearchResult as JResult, choose_chains as jchoose)
from cuda_satabsearch_tpu import session as jsession  # noqa: E402
from cuda_satabsearch_tpu.stats import gumbel as jgumbel  # noqa: E402
from cuda_satabsearch_tpu.stats import norms as jnorms  # noqa: E402
from cuda_satabsearch_tpu_torch.io import pack as tpack  # noqa: E402
from cuda_satabsearch_tpu_torch.io import parser as tparser  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import common as tcommon  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.search import (  # noqa: E402
    SearchResult as TResult, choose_chains as tchoose)
from cuda_satabsearch_tpu_torch import session as tsession  # noqa: E402
from cuda_satabsearch_tpu_torch.stats import gumbel as tgumbel  # noqa: E402
from cuda_satabsearch_tpu_torch.stats import norms as tnorms  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
DB_FILES = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(FIXTURES, "*.ascii")))
INPUT_FILES = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(FIXTURES, "*.input")))


def _entries(parser, name):
    path = os.path.join(FIXTURES, name)
    if name.endswith(".ascii"):
        return parser.read_database(path)
    with open(path) as fp:
        return parser.parse_search_input(fp).queries


def _assert_packed_equal(a, b):
    assert a.nentries == b.nentries and a.names == b.names
    np.testing.assert_array_equal(a.orders, b.orders)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.dim == y.dim and x.names == y.names
        for f in ("tabhi", "tablo", "types", "dmat", "orders", "index"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u.view(np.uint8), v.view(np.uint8))


@pytest.mark.parametrize("name", DB_FILES + INPUT_FILES)
def test_parse_and_pack_bitwise(name):
    try:
        je = _entries(jparser, name)
    except ValueError as e:  # a malformed fixture: same error, same text
        with pytest.raises(ValueError) as te:
            _entries(tparser, name)
        assert str(te.value) == str(e)
        return
    te = _entries(tparser, name)
    assert [e.name for e in je] == [e.name for e in te]
    for a, b in zip(je, te):
        for f in ("tabhi", "tablo", "types", "dmat"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        qa, qb = jpack.pack_query(a), tpack.pack_query(b)
        for f in ("tabhi", "tablo", "types", "dmat"):
            np.testing.assert_array_equal(getattr(qa, f).view(np.uint8),
                                          getattr(qb, f).view(np.uint8))
    if je:
        _assert_packed_equal(jpack.pack_database(je),
                             tpack.pack_database(te))


def test_search_input_header_fields():
    for name in INPUT_FILES:
        with open(os.path.join(FIXTURES, name)) as fp:
            a = jparser.parse_search_input(fp)
        with open(os.path.join(FIXTURES, name)) as fp:
            b = tparser.parse_search_input(fp)
        assert (a.dbfile, a.ltype, a.lorder, a.lsoln) == (
            b.dbfile, b.ltype, b.lorder, b.lsoln)


def test_quantize_dmat_bitwise_edge_values():
    """torch's bf16 rounding equals ml_dtypes' (round to nearest even),
    including exact ties, subnormals, huge values and the DMAT_PAD."""
    r = np.random.default_rng(0)
    bits = r.integers(0, 2 ** 32, size=200000, dtype=np.uint64).astype(
        np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    ties = (np.arange(1, 4000, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    extra = np.array([0.0, -0.0, 1e9, 3.999, 4.0, 4.001, 1e-40, 3.4e38],
                     np.float32)
    for v in (x, ties, extra, (r.random(5000) * 30).astype(np.float32)):
        np.testing.assert_array_equal(
            tpack.quantize_dmat(v).view(np.uint32),
            jpack.quantize_dmat(v).view(np.uint32))


@pytest.mark.parametrize("n1", [1, 5, 8, 13, 19, 101])
def test_query_layout_helpers(n1):
    from conftest import random_entry

    q = jpack.pack_query(random_entry(np.random.default_rng(n1), n1, "q"))
    assert tcommon.round8(n1) == jcommon.round8(n1)
    assert tcommon.slots_per_restart(n1) == jcommon.slots_per_restart(n1)
    jq = jcommon.prepare_query(q, jcommon.round8(n1))
    for a, b in zip(tcommon.prepare_query(q, tcommon.round8(n1)),
                    (jq[0], jq[2], jq[3])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for maxstart in (1, 8, 100, 128, 4096, 127 * 3):
        assert tchoose(maxstart) == jchoose(maxstart)


def test_score_stats_and_norms_bitwise():
    r = np.random.default_rng(3)
    score = r.integers(-20, 400, size=500)
    qn = 13
    dbn = r.integers(2, 112, size=500)
    for compat in (False, True):
        for a, b in zip(tgumbel.score_stats(score, qn, dbn, compat=compat),
                        jgumbel.score_stats(score, qn, dbn, compat=compat)):
            np.testing.assert_array_equal(a, b)
    for f in ("norm1", "norm2", "norm3"):
        np.testing.assert_array_equal(getattr(tnorms, f)(score, qn, dbn),
                                      getattr(jnorms, f)(score, qn, dbn))
    np.testing.assert_array_equal(tnorms.empirical_zscores(score),
                                  jnorms.empirical_zscores(score))


@pytest.mark.parametrize("lsoln,compat", [(True, False), (False, True)])
def test_format_results_text_identical(lsoln, compat):
    db = jpack.pack_database(jparser.read_database(
        os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")))
    r = np.random.default_rng(5)
    n1 = 8
    scores = r.integers(-5, 60, size=db.nentries).astype(np.int32)
    maps = r.integers(-1, 20, size=(db.nentries, n1)).astype(np.int32)
    kw = dict(scores=scores, ssemaps=maps, names=db.names, orders=db.orders,
              query_order=n1, maxstart=128)
    outs = []
    for sess, res in ((jsession, JResult(**kw)), (tsession, TResult(**kw))):
        buf = io.StringIO()
        sess.print_query_header("prog", True, True, lsoln, "D1UBIA_",
                                "db.ascii", out=buf)
        sess.format_results(res, n1, lsoln=lsoln, compat_z=compat, out=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
