"""On the card (skipped elsewhere): query lists at 4,096 restarts (128
chains of 32 restarts in order) against the DB of the
``astral14291_r4096`` configuration, the seed's 14,291-entry file made
by ``satbench.deploy.prepare``.

* ``search_many`` of 8 queries of mixed width (round8 groups of two
  queries, which run unsplit, and of one) equals the plain reference
  (satbench/reference/sa.py) bit for bit on sampled entries: scores,
  and norm2 / z / p against satbench/reference/stats.py.

That a one-query group's split search equals bit for bit its row in an
unsplit 64-query tile on this DB is a case of
tests/test_torch_restart_split_card.py::test_a_split_query_equals_its_row_of_an_unsplit_list.

The test stops the process past ``LIMIT_S`` seconds.  On the card's
host, which has no JAX (that ``tests/conftest.py`` imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_r4096_lists_card.py
"""

import faulthandler
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch.ops import sa_kernel
from cuda_satabsearch_tpu_torch.ops.common import round8
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig
from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats
from satbench import deploy
from satbench.reference import sa
from satbench.reference.stats import score_stats as ref_stats

pytestmark = pytest.mark.card

CONFIG = Path(__file__).resolve().parent.parent / "satbench" / "configs" / \
    "astral14291_r4096.json"
SEED = 2 ** 31 + 1807  # a --seed past 31 bits; the session takes % 2**31
LIMIT_S = 600  # the process is stopped past it
PER_QUERY = 6  # sampled entries a query, besides its own and the widest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    faulthandler.dump_traceback_later(LIMIT_S, exit=True)
    yield torch.cuda.get_device_name(0)
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """(session, the benchmark's index of the DB file) of the seed."""
    config = json.loads(CONFIG.read_text())
    assert config["maxstart"] == 4096 and config["db"]["entries"] == 14291
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    dep = deploy.prepare("astral14291_r4096", config, SEED,
                         tmp_path_factory.mktemp("cache"))
    sess = SearchSession(str(dep.path), SessionConfig(
        maxstart=config["maxstart"], seed=SEED % 2 ** 31))
    return sess, dep.index


def shape(sess, K, n1r):
    kw = sess.searcher.kw
    return sa_kernel.launch_shape(sess.device_db[0], K, n1r,
                                  c_par=kw["c_par"], r_seq=kw["r_seq"],
                                  lsoln=False)


def mixed_list(orders):
    """Entry indices of 8 queries: two each of round8 8 and 16, one each
    of 24, 32, 48 and 64."""
    picks = []
    for r8, n in ((8, 2), (16, 2), (24, 1), (32, 1), (48, 1), (64, 1)):
        (at,) = np.nonzero([round8(int(o)) == r8 for o in orders])
        picks += [int(i) for i in at[len(at) // 2:len(at) // 2 + n]]
    assert len(picks) == 8
    return picks


def test_a_mixed_list_equals_the_reference(card, deployment):
    sess, index = deployment
    picks = mixed_list(index.orders)
    groups = Counter(round8(int(index.orders[i])) for i in picks)
    shapes = {r8: shape(sess, K, r8) for r8, K in groups.items()}
    assert shapes[8][0] == shapes[16][0] == 1  # two queries: unsplit
    first = sess._query_tag  # search_many tags a list by its positions
    t0 = time.perf_counter()
    results = sess.search_many([sess.resolve_query(index.names[i])
                                for i in picks], lorder=True, lsoln=False)
    took = time.perf_counter() - t0
    rng = np.random.default_rng(SEED % 2 ** 32)
    widest = int(np.argmax(index.orders))
    pairs = [(k, int(e)) for k, qi in enumerate(picks)
             for e in sorted(set(rng.choice(len(index.names), PER_QUERY,
                                            replace=False)) | {qi, widest})]
    entry = {i: index.entry(i) for i in {e for _, e in pairs} | set(picks)}
    t1 = time.perf_counter()
    scores, _ = sa.search_pairs(
        [entry[picks[k]] for k, _ in pairs], [entry[e] for _, e in pairs],
        [first + k for k, _ in pairs], [e for _, e in pairs],
        seed=SEED % 2 ** 31, maxstart=4096, lorder=True, lsoln=False,
        device="cuda")
    print(f"\n{card}: 8 queries, (S, lanes) by round8 {shapes}; list "
          f"{took:.2f} s, reference of {len(pairs)} pairs "
          f"{time.perf_counter() - t1:.2f} s")
    stats = [score_stats(r.scores, index.orders[qi], r.orders)
             for qi, r in zip(picks, results)]
    for b, (k, e) in enumerate(pairs):
        res = results[k]
        assert res.names == index.names
        assert res.scores[e] == scores[b], (picks[k], e)
        want = ref_stats(scores[b:b + 1], index.orders[picks[k]],
                         index.orders[e:e + 1])
        for g, w in zip(stats[k], want):
            assert np.float64(g[e]).tobytes() == w[0].tobytes()

