"""On the card (skipped elsewhere): long chains on the graph path, and the
launch figures of the ``kernel_search.enqueue`` span.

At 4,096 restarts (128 parallel chains of 32 restarts each) on the
586-entry DB, for one query of every round8 width of the DB with LSOLN
off (LORDER on, as the acceptance deployment searches): the key's first
search (eager), its second (eager, then the capture) and its third and
fourth (replays) equal, bit for bit, a session that searches eagerly
only.  Each replay's enqueue span carries its captured launches'
figures: CTAs one per (column, query, restart split) of the plan, CTA
slots the card's SMs times each launch class's resident CTAs per SM
(``sa_kernel.occupancy``), and a chain of maxiter x 32 / S moves, S
the launches' split (``sa_kernel.restart_split``: one query fills
under half a wave of the card, so S is 32); the figures and the share
of the card they fill are printed (``-s``).  On
the card's host, which has no JAX (that ``tests/conftest.py`` imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_long_chains_card.py
"""

import os

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch import trace
from cuda_satabsearch_tpu_torch.ops import sa_kernel
from cuda_satabsearch_tpu_torch.ops.common import round8
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
MAXSTART = 4096  # 128 chains x 32 restarts


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


def count_replays(sess) -> list:
    """The session's graph replays, counted through its capture seam
    (ops/search.Searcher.capture)."""
    replays, capture = [], sess.searcher.capture

    def counted(fn):
        replay = capture(fn)
        return lambda: replays.append(replay())
    sess.searcher.capture = counted
    return replays


def test_long_chain_graphs_equal_eager_and_carry_the_figures(card):
    cfg = SessionConfig(maxstart=MAXSTART, seed=2 ** 31 - 9)
    sess, eager = (SearchSession(DB586, cfg) for _ in range(2))
    eager.searcher.capture = None
    assert sess.searcher.capture is not None
    assert sess.searcher.kw["r_seq"] == 32
    plan = sess.device_db[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert plan.sms == sms and len(plan.classes) == 2
    firsts = {}
    for i, o in enumerate(sess.db.orders):
        firsts.setdefault(round8(int(o)), sess.db.names[i])
    replays = count_replays(sess)
    for width, name in sorted(firsts.items()):
        q = sess.resolve_query(name)
        tag = 5000 + width
        ref = eager.search(q, lsoln=False, query_tag=tag)
        trace.clear()
        for _ in range(4):  # eager, eager and capture, replay, replay
            with trace.recording():
                got = sess.search(q, lsoln=False, query_tag=tag)
            np.testing.assert_array_equal(got.scores, ref.scores)
            assert got.ssemaps is None
        spans = [s for s in trace.spans()
                 if s.name == "kernel_search.enqueue"]
        assert len(spans) == 4
        per_sm = [sa_kernel.occupancy(cls.d2max, width, 128, False)[0]
                  for cls in plan.classes]
        split = sa_kernel.restart_split(plan, 1, width, c_par=128, r_seq=32,
                                        lsoln=False)
        assert split == 32
        want = (plan.nentries * split, sms * sum(per_sm), 100 * 32 // split)
        for s in spans:  # eager and replayed alike
            assert (s.ctas, s.cta_slots, s.chain_moves) == want
        print(f"\n{card}: n1r {width:3d}: {want[0]} CTAs ({split} splits), "
              f"{want[1]} slots ({sms} SMs x {per_sm} per SM, wide and "
              f"narrow class), fill {100 * min(1, want[0] / want[1]):.1f} %, "
              f"{want[2]} moves a chain", end="")
    assert len(replays) == 2 * len(firsts)
