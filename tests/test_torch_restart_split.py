"""The restart split of the SA launch plan, on the CPU.

A launch that would fill few waves of the card runs each (entry, query)
as S CTAs, split z running restarts [z r_seq / S, (z + 1) r_seq / S) of
every chain, and a reduction makes the entry's result: the largest of
the splits' best scores, then the lowest winning chain, then the lowest
split, whose map is the entry's (csrc/sa_search.cu).

* A plain model of that (each split's chains run by the plain engine,
  ``search_plain``, one chain at a time on its slice of the stream, then
  reduced as the kernel reduces) equals the unsplit plain engine bit for
  bit on entries of the 586-entry DB: S 2, 4 and 8, LORDER and LSOLN
  true and false, and cases built to tie (a 3-SSE query, 2 moves), in
  which the lowest maximal chain sits in a later split than the first
  one to reach the max.
* ``sa_kernel.restart_split`` (occupancy stubbed): 1 where r_seq is odd,
  with no occupancy query; the least power of two dividing r_seq that
  fills ``SPLIT_WAVES`` waves, else the largest; 1 for a 64-query tile;
  one occupancy query per class and key.
* ``launch_figures`` under a split: ``ctas`` = K x entries x S,
  ``chain_moves`` = maxiter x r_seq / S.
* A replayed graph adds its capture's split launches to
  ``sa_search.split_launches``.

The kernel's split is held against its unsplit launch on the card in
tests/test_torch_restart_split_card.py.
"""

import dataclasses
import os
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import (  # noqa: E402
    kernel_search, rng, sa_kernel)
from cuda_satabsearch_tpu_torch.ops.common import (  # noqa: E402
    round8, slots_per_restart)
from cuda_satabsearch_tpu_torch.ops.engine import search_plain  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    launch_figures, pack_queries)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (  # noqa: E402
    SPLIT_WAVES, restart_split)
from cuda_satabsearch_tpu_torch.ops.search import Searcher  # noqa: E402
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
SMS = 132
C_PAR, R_SEQ = 4, 8  # 4 chains of 8 restarts in order
SEED = 2 ** 31 - 3


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sess():
    return SearchSession(DB586, SessionConfig(maxstart=128, device="cpu"))


def query(sess, order):
    """The first DB entry of ``order`` SSEs as a packed query (K = 1)."""
    name = sess.db.names[list(sess.db.orders).index(order)]
    q = sess.resolve_query(name)
    return pack_queries([q], round8(order), "cpu")


def bucket_rows(sess, dim, n):
    """The first n rows of the plan's bucket of width ``dim``."""
    (b,) = [b for b in sess.device_db[0].buckets if b.dim == dim]
    return b, np.arange(n)


def stream(b, rows, n1r, params, tag):
    keys = rng.entry_keys(SEED, [tag], b.index[rows])
    return rng.make_uniforms(keys, R_SEQ, slots_per_restart(
        n1r, params.maxiter), C_PAR, n1r)


def split_search(q, b, rows, u, split, lorder, params):
    """The kernel's split, plainly: split z's chains run one at a time
    (``search_plain`` at c_par 1 on chain c's slots of restarts z r_seq /
    S ..) and reduce as the kernel does.  Returns (scores [1, E], maps
    [1, E, n1r], and per split its (best, winner, winner's map))."""
    K, n1r = q[0].shape
    E, r = len(rows), R_SEQ // split
    tables = [x[rows].repeat_interleave(C_PAR, 0)
              for x in (b.types, b.tab, b.dmat, b.n2)]
    chains = torch.arange(C_PAR)
    parts = []
    for z in range(split):
        uz = u[:, :, z * r:(z + 1) * r]  # [K, E, r, P, C]
        uz = uz.permute(0, 1, 4, 2, 3).reshape(K, E * C_PAR, r, -1, 1)
        s, m = search_plain(*q, *tables, uniforms=uz.contiguous(), c_par=1,
                            r_seq=r, lorder=lorder, lsoln=True,
                            params=params)
        s, m = s.view(K, E, C_PAR), m.view(K, E, C_PAR, n1r)
        best = s.amax(2)
        winner = torch.where(s == best[..., None], chains, C_PAR).amin(2)
        wmap = torch.gather(m, 2, winner[..., None, None].expand(
            K, E, 1, n1r))[:, :, 0]
        parts.append((best, winner, wmap))
    best, winner, wmap = parts[0]
    for b2, w2, m2 in parts[1:]:  # strictly better: the lowest split stays
        take = (b2 > best) | ((b2 == best) & (w2 < winner))
        best = torch.where(take, b2, best)
        winner = torch.where(take, w2, winner)
        wmap = torch.where(take[..., None], m2, wmap)
    return best, wmap, parts


def unsplit(q, b, rows, u, lorder, lsoln, params):
    return search_plain(*q, b.types[rows], b.tab[rows], b.dmat[rows],
                        b.n2[rows], uniforms=u, c_par=C_PAR, r_seq=R_SEQ,
                        lorder=lorder, lsoln=lsoln, params=params)


@pytest.mark.parametrize("lsoln", [False, True])
@pytest.mark.parametrize("lorder", [True, False])
@pytest.mark.parametrize("split", [2, 4, 8])
def test_the_split_equals_the_unsplit_chains(sess, split, lorder, lsoln):
    """A 12-SSE query against three narrow and one wide entry."""
    q = query(sess, 12)
    for dim, n in ((16, 3), (48, 1)):
        b, rows = bucket_rows(sess, dim, n)
        u = stream(b, rows, 16, DEFAULTS, tag=split)
        scores, maps = unsplit(q, b, rows, u, lorder, lsoln, DEFAULTS)
        got, gmaps, _ = split_search(q, b, rows, u, split, lorder,
                                     DEFAULTS)
        assert torch.equal(got.int(), scores)
        if lsoln:
            assert torch.equal(gmaps.int(), maps)


@pytest.mark.parametrize("split", [2, 4, 8])
def test_ties_go_to_the_lowest_chain_then_the_lowest_split(sess, split):
    """A 3-SSE query and 5 moves a restart against 8 entries: many chains
    of many splits reach the max with other maps, and in some entry the
    map of the first split to reach the max (its own lowest maximal
    chain's) is not the unsplit result, so the order of the tie-break
    decides the map (the stream's tag is one at which that happens for
    every split tested)."""
    params = dataclasses.replace(DEFAULTS, maxiter=5)
    q = query(sess, 3)
    b, rows = bucket_rows(sess, 16, 8)
    u = stream(b, rows, 8, params, tag=5)
    scores, maps = unsplit(q, b, rows, u, True, True, params)
    got, gmaps, parts = split_search(q, b, rows, u, split, True, params)
    assert torch.equal(got.int(), scores)
    assert torch.equal(gmaps.int(), maps)
    first = parts[0][2].clone()
    for best, _, wmap in reversed(parts):
        first = torch.where((best == got)[..., None], wmap, first)
    assert (first.int() != maps).any()


def fake_occupancy(calls):
    def occupancy(d2max, n1r, c_par, lsoln, split=False, lanes=1):
        calls.append((d2max, n1r, c_par, lsoln))
        return (5 if d2max > 32 else 10), 48, 0
    return occupancy


@pytest.fixture
def on_a_card(monkeypatch):
    """The 586-entry DB's plan on ``SMS`` SMs, occupancy stubbed (10
    narrow, 5 wide CTAs per SM); returns (session, the stub's calls)."""
    calls = []
    monkeypatch.setattr(kernel_search, "sm_count", lambda device: SMS)
    monkeypatch.setattr(sa_kernel, "occupancy", fake_occupancy(calls))
    sess = SearchSession(DB586, SessionConfig(maxstart=4096, device="cpu"))
    return sess, calls


def waves(plan, K):
    return sum(Fraction(K * cls.entries, SMS * (5 if cls.d2max > 32 else 10))
               for cls in plan.classes)


@pytest.mark.parametrize("r_seq", [1, 3])
def test_odd_restarts_do_not_split_or_ask_the_card(on_a_card, r_seq):
    sess, calls = on_a_card
    plan = sess.device_db[0]
    for K in (1, 64):
        assert restart_split(plan, K, 16, c_par=128, r_seq=r_seq,
                             lsoln=False) == 1
    assert calls == []


@pytest.mark.parametrize("K, want", [(1, 32), (2, 32), (4, 16), (8, 8),
                                     (16, 4), (32, 2), (64, 1)])
def test_the_split_fills_the_card_with_waves(on_a_card, K, want):
    """586 entries (556 narrow, 30 wide) at r_seq 32: 0.467 waves a
    query unsplit, so one query splits 32 ways (14.9 waves) and a
    64-query tile (29.9 waves) not at all."""
    sess, calls = on_a_card
    plan = sess.device_db[0]
    assert [cls.entries for cls in plan.classes] == [30, 556]
    assert waves(plan, 1) == Fraction(30, 660) + Fraction(556, 1320)
    got = restart_split(plan, K, 16, c_par=128, r_seq=32, lsoln=False)
    assert got == want
    assert waves(plan, K) * got >= SPLIT_WAVES or got == 32
    assert got == 1 or waves(plan, K) * got // 2 < SPLIT_WAVES


@pytest.mark.parametrize("K", [1, 2, 3, 5, 64])
def test_the_split_is_a_power_of_two_that_divides_r_seq(on_a_card, K):
    sess, calls = on_a_card
    plan = sess.device_db[0]
    for r_seq in range(1, 65):
        s = restart_split(plan, K, 24, c_par=128, r_seq=r_seq, lsoln=True)
        assert r_seq % s == 0 and s & (s - 1) == 0
        # the least that fills the waves, or as far as r_seq allows
        assert (waves(plan, K) * s >= SPLIT_WAVES) or r_seq % (2 * s)
        assert s == 1 or waves(plan, K) * s // 2 < SPLIT_WAVES
    # one occupancy query per class and key, none per call
    assert len(calls) == len(plan.classes)


def test_no_split_off_a_card(sess):
    plan = sess.device_db[0]
    assert plan.sms == 0
    assert restart_split(plan, 1, 16, c_par=128, r_seq=32, lsoln=False) == 1
    assert launch_figures(plan, 1, 16, c_par=128, r_seq=32, lsoln=False,
                          maxiter=100) == (586, 0, 3200)


@pytest.mark.parametrize("K", [1, 4, 64])
def test_launch_figures_count_the_split_ctas_and_chains(on_a_card, K):
    sess, _ = on_a_card
    plan = sess.device_db[0]
    split = restart_split(plan, K, 16, c_par=128, r_seq=32, lsoln=False)
    ctas, slots, moves = launch_figures(plan, K, 16, c_par=128, r_seq=32,
                                        lsoln=False, maxiter=100)
    assert ctas == K * 586 * split
    assert slots == SMS * (5 + 10)
    assert moves == 100 * 32 // split


def test_a_replay_adds_its_captures_split_launches(on_a_card, monkeypatch):
    """The graph path with a capture that runs the function itself and a
    stand-in for the wrapper that counts as the card's would while
    capturing: each replay adds the captured split launches."""
    sess, _ = on_a_card
    plan = sess.device_db[0]
    real, capturing = kernel_search.sa_search, []

    def counted(*args, **kw):
        if capturing:
            split = restart_split(args[4], 1, args[0].shape[1],
                                  c_par=kw["c_par"], r_seq=kw["r_seq"],
                                  lsoln=kw["lsoln"])
            counted.launches += len(args[4].classes)
            counted.split_launches += len(args[4].classes) * (split > 1)
        return real(*args, **kw)

    def capture(fn):
        capturing.append(fn)
        fn()
        capturing.pop()
        return fn

    counted.launches = counted.split_launches = counted.lane_launches = 0
    monkeypatch.setattr(kernel_search, "sa_search", counted)
    maxiter2 = dataclasses.replace(DEFAULTS, maxiter=2)
    # 2 chains of 2 restarts in order, on the kernel's wrapper
    searcher = Searcher(sess.db, [plan], maxstart=4, c_max=2, seed=5,
                        params=maxiter2)
    searcher.capture = capture
    q = sess.resolve_query(sess.db.names[0])
    for _ in range(2):  # a key's second search captures its graph
        searcher.search(q, 0, lorder=True, lsoln=False)
    (g,) = searcher.graphs.values()
    assert g.steps[0].launches == (2, 2, 0)
    assert (counted.launches, counted.split_launches) == (0, 0)
    for _ in range(3):
        searcher.search(q, 0, lorder=True, lsoln=False)
    assert (counted.launches, counted.split_launches) == (6, 6)
