"""The port's ranking-parity metrics (cuda_satabsearch_tpu_torch/eval/)
against the JAX package's, and the acceptance row that
``eval/acceptance_eval.py`` computes (chip_smoke.py's gate calls it): on
the CPU, the port's ``-c`` row for d1ubia_ on the 586-entry DB equals
the JAX package's ``-c`` row (the two search the same stream, bitwise,
and rank by the same norm2)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu.eval import acceptance as jacc  # noqa: E402
from cuda_satabsearch_tpu.eval import roc as jroc  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import acceptance as tacc  # noqa: E402
from cuda_satabsearch_tpu_torch.eval.acceptance_eval import (  # noqa: E402
    DB586, FIXTURES, GOLDEN, QUERIES, load_scores, parity_row)
from cuda_satabsearch_tpu_torch.eval import roc as troc  # noqa: E402


def _score_dicts(seed, n=300):
    """Two {name: score} dicts over overlapping names, small-integer
    scores (ties are the norm) and a few names only one side has."""
    rng = np.random.default_rng(seed)
    names = [f"d{i:04d}" for i in range(n)]
    a = rng.integers(0, 40, n).astype(float)
    b = np.clip(a + rng.integers(-6, 7, n), 0, None)
    da = dict(zip(names, a))
    db = dict(zip(names[5:] + ["extra1", "extra2"],
                  list(b[5:]) + [3.0, 50.0]))
    return da, db


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax_package(seed):
    a, b = _score_dicts(seed)
    assert tacc.spearman(a, b) == jacc.spearman(a, b)
    for k in (10, 50):
        assert tacc.topk_overlap(a, b, k) == jacc.topk_overlap(a, b, k)
    for q in (0.05, 0.2):
        assert tacc.retrieval_auc(a, b, q) == jacc.retrieval_auc(a, b, q)
    assert tacc.parity_report(a, b).row() == jacc.parity_report(a, b).row()
    assert (tacc.parity_report(a, b).__dict__
            == jacc.parity_report(a, b).__dict__)


@pytest.mark.parametrize("seed", [3, 4])
def test_roc_equal_jax_package(seed):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 12, 200).astype(float)
    labels = rng.random(200) < 0.2
    for x, y in zip(troc.roc_curve(scores, labels),
                    jroc.roc_curve(scores, labels)):
        np.testing.assert_array_equal(x, y)
    assert troc.auc(scores, labels) == jroc.auc(scores, labels)
    assert troc.roc_n(scores, labels, 20) == jroc.roc_n(scores, labels, 20)


def test_golden_scores_read_every_entry():
    for q in QUERIES:
        for r in (128, 4096):
            gold = load_scores(os.path.join(GOLDEN, f"{q}_small_r{r}.out"))
            assert len(gold) == 586, (q, r)


def test_cpu_parity_row_equals_jax_package():
    """d1ubia_ at r = 8 on the 586-entry DB against the oracle's r = 128
    output: the port's row (acceptance_eval.parity_row on the plain
    engine, CPU) == the JAX package's (``-c``: its XLA engine on the CPU,
    ranked as scripts/acceptance_eval.py ranks)."""
    from cuda_satabsearch_tpu.io.pack import pack_query as jpack_query
    from cuda_satabsearch_tpu.io.parser import parse_search_input
    from cuda_satabsearch_tpu.session import (
        SearchSession as JSession, SessionConfig as JConfig)
    from cuda_satabsearch_tpu.stats.gumbel import norm2
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    jsess = JSession(DB586, JConfig(maxstart=8, backend="xla"))
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        query = jpack_query(parse_search_input(fp).queries[0])
    res = jsess.search(query, lorder=True, lsoln=False)
    ours = {res.names[i]: norm2(int(res.scores[i]), 8, int(res.orders[i]))
            for i in range(res.nentries)}
    ref = jacc.parity_report(ours, load_scores(os.path.join(
        GOLDEN, "d1ubia__small_r128.out")))

    sess = SearchSession(DB586, SessionConfig(maxstart=8, device="cpu"))
    got, ms = parity_row(sess, "d1ubia_", 128)
    assert got.__dict__ == ref.__dict__
    assert got.row() == ref.row()
    assert ms > 0
    assert 0.5 < got.auc5 <= 1.0
