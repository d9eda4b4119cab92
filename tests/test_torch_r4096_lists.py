"""Query lists whose chains run restarts in order, and the launch shape of
such lists against the ASTRAL-scale DB, on the CPU.

* A session of 10 entries drawn by ``satbench.synth.astral_entries`` (the
  generator of the ``astral14291_r4096`` configuration's DB), narrow and
  wide, at 258 restarts (86 parallel chains of 3 restarts in order,
  ``choose_chains``): ``search_many`` of a list of two round8 groups, one
  of them a single query, equals the benchmark's plain reference
  (satbench/reference/sa.py) bit for bit at LORDER=T and LSOLN=F:
  scores, and norm2 / z / p against satbench/reference/stats.py.
* Against a plan of the 14,291-entry DB's shape (its buckets' rows and
  no data), on 132 SMs with ``sa_kernel.occupancy`` stubbed, at 4,096
  restarts (128 chains of 32): a 64-query tile takes S = 1 at one lane
  a chain, one query takes the least power of two that fills
  ``SPLIT_WAVES`` waves (2 here), and each enqueue span names its tile
  (``queries``, ``n1r``) and carries ``ctas`` = K x entries x S.

The unsplit 32-restart loop is held against the reference on the card
in tests/test_torch_r4096_lists_card.py.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch import trace  # noqa: E402
from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import DEFAULT_BUCKETS  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import (  # noqa: E402
    kernel_search, sa_kernel)
from cuda_satabsearch_tpu_torch.ops.common import round8  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    NARROW_MAX, LaunchClass, Plan, Step)
from cuda_satabsearch_tpu_torch.ops.search import choose_chains  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)
from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats  # noqa: E402
from satbench import synth  # noqa: E402
from satbench.reference import dbfile, sa  # noqa: E402
from satbench.reference.stats import score_stats as ref_stats  # noqa: E402

MAXSTART = 258  # 86 chains x 3 restarts in order
SEED = 2 ** 31 - 101
SMS = 132
ASTRAL_ENTRIES = 14291


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
    """(path, index) of 10 entries of a 400-entry draw of the ASTRAL-like
    generator, spread over its sizes from the smallest to the widest:
    narrow and wide buckets, so both launch classes."""
    drawn = synth.astral_entries(400, 2024)
    picks = [drawn[i] for i in np.linspace(0, len(drawn) - 1, 10).astype(int)]
    path = tmp_path_factory.mktemp("db") / "ten.ascii"
    path.write_text(synth.format_database(picks))
    index = dbfile.index_file(str(path))
    assert len(index.names) == 10
    assert index.orders.min() <= NARROW_MAX < index.orders.max()
    return str(path), index


@pytest.fixture(scope="module")
def sess(db):
    return SearchSession(db[0], SessionConfig(maxstart=MAXSTART, seed=SEED,
                                              device="cpu"))


def two_groups(orders, single_wide: bool):
    """Entry indices of a list of two round8 groups: the last two entries
    of the widest round8 that holds several, and the one entry of the
    widest round8 that holds one (``single_wide``: a wide query) or of
    the narrowest."""
    by_r8: dict = {}
    for i, o in enumerate(orders):
        by_r8.setdefault(round8(int(o)), []).append(i)
    pair = [v[-2:] for v in by_r8.values() if len(v) >= 2][-1]
    singles = [v[0] for v in by_r8.values() if len(v) == 1]
    single = singles[-1] if single_wide else singles[0]
    assert (orders[single] > NARROW_MAX) == single_wide
    return [pair[0], single, pair[1]]


@pytest.mark.parametrize("single_wide", [True, False],
                         ids=["single-wide", "single-narrow"])
def test_a_list_of_two_groups_equals_the_reference(db, sess, single_wide):
    _, index = db
    entries = [index.entry(i) for i in range(len(index.names))]
    E = len(entries)
    picks = two_groups(index.orders, single_wide)
    first = sess._query_tag  # search_many tags a list by its positions
    results = sess.search_many([sess.resolve_query(index.names[i])
                                for i in picks], lorder=True, lsoln=False)
    for k, (qi, res) in enumerate(zip(picks, results)):
        tag = first + k
        scores, _ = sa.search_pairs([entries[qi]] * E, entries, [tag] * E,
                                    list(range(E)), seed=SEED,
                                    maxstart=MAXSTART, lorder=True,
                                    lsoln=False, device="cpu")
        assert res.names == index.names
        np.testing.assert_array_equal(res.scores, scores)
        got = score_stats(res.scores, entries[qi].order, res.orders)
        want = ref_stats(scores, entries[qi].order, index.orders)
        for g, w in zip(got, want):
            assert np.asarray(g, np.float64).tobytes() == w.tobytes()


def occupancy(d2max, n1r, c_par, lsoln, split=False, lanes=1):
    """A stand-in for the card's: 10 narrow and 5 wide CTAs per SM at
    one lane a chain, fewer at more lanes."""
    return max(1, (5 if d2max > NARROW_MAX else 10) // lanes), 48, 0


@pytest.fixture
def astral_plan(monkeypatch):
    """A plan of the 14,291-entry DB's shape on ``SMS`` SMs: each launch
    class's buckets with as many rows as the generator's size mix puts
    in them, widest first, and no data."""
    monkeypatch.setattr(sa_kernel, "occupancy", occupancy)
    orders = synth.sse_counts(np.random.default_rng(7), ASTRAL_ENTRIES)
    caps = np.asarray(DEFAULT_BUCKETS)
    dims, rows = np.unique(caps[np.searchsorted(caps, orders)],
                           return_counts=True)
    classes = []
    for wide in (True, False):
        members = [(kernel_search.DeviceBucket(
                        dim=int(d), types=None, tab=None, dmat=None, n2=None,
                        index=np.zeros(int(n), np.int32), index_dev=None), 0)
                   for d, n in sorted(zip(dims, rows), reverse=True)
                   if (d > NARROW_MAX) == wide]
        classes.append(LaunchClass(buckets=members, d2max=members[0][0].dim,
                                   desc=None))
    return Plan(device=torch.device("cpu"), buckets=[],
                index=np.zeros(ASTRAL_ENTRIES, np.int32), classes=classes,
                sms=SMS, order=None, file_index=np.arange(ASTRAL_ENTRIES),
                whole=True)


def least_split(plan, K, r_seq):
    """The restart split by its definition: the least power of two that
    divides r_seq and fills SPLIT_WAVES waves of the stub's slots, else
    the largest."""
    waves = sum(Fraction(K * cls.entries, SMS * occupancy(cls.d2max, 0, 0,
                                                          False)[0])
                for cls in plan.classes)
    s = 1
    while waves * s < sa_kernel.SPLIT_WAVES and r_seq % (2 * s) == 0:
        s *= 2
    return s


@pytest.mark.parametrize("K, want", [(1, 2), (2, 1), (8, 1), (64, 1)])
def test_an_astral_list_splits_only_its_one_query_groups(astral_plan, K,
                                                         want):
    """14,291 entries fill about 11 waves a query at one lane, so a
    one-query group splits 2 ways and a group of two or more, a 64-query
    tile too, runs each chain's 32 restarts in order in one CTA."""
    plan = astral_plan
    assert sum(cls.entries for cls in plan.classes) == ASTRAL_ENTRIES
    c_par, r_seq = choose_chains(4096)
    assert (c_par, r_seq) == (128, 32)
    split, lanes = sa_kernel.launch_shape(plan, K, 16, c_par=c_par,
                                          r_seq=r_seq, lsoln=False)
    assert split == least_split(plan, K, r_seq) == want
    assert lanes == (1, 1)


@pytest.mark.parametrize("K, n1r", [(1, 8), (1, 48), (3, 16), (64, 24)])
def test_the_enqueue_span_names_its_tile(astral_plan, K, n1r):
    plan = astral_plan
    c_par, r_seq = choose_chains(4096)
    step = Step(plan, K, n1r, backend="torch", lorder=True, lsoln=False,
                seed=SEED, c_par=c_par, r_seq=r_seq, params=DEFAULTS)
    with trace.recording():
        step.enqueue(lambda: None, 7, K)
    (s,) = [s for s in trace.spans() if s.name == "kernel_search.enqueue"]
    split = least_split(plan, K, r_seq)
    assert (s.tag, s.queries, s.n1r) == (7, K, n1r)
    assert s.ctas == K * ASTRAL_ENTRIES * split
    assert s.chain_moves == DEFAULTS.maxiter * r_seq // split
    assert s.cta_slots == sum(SMS * occupancy(cls.d2max, n1r, c_par,
                                              False)[0]
                              for cls in plan.classes)
