"""On the card (skipped elsewhere): the SA kernel's restart split.

* At 4,096 restarts (128 chains x 32 in order) and at 256 (x 2), LSOLN
  off and on, on the 586-entry DB and on the 14,291-entry DB of the
  ``astral14291_r4096`` configuration (the seed's file, made by
  ``satbench.deploy.prepare``): one query searched alone, which splits
  (``sa_kernel.restart_split``: a query fills under ``SPLIT_WAVES``
  waves of the card), equals bit for bit its row of one 64-query
  ``search_many`` of the same width, which does not split: scores, and
  maps under LSOLN.  ``sa_search.split_launches`` counts the split
  launches and nothing else.
* The graph path at 4,096 restarts: a key's replays equal an eager
  session's searches, and each replay adds its captured split launches.
* ptxas reports no spill for any one-lane instantiation (the kernel's
  source compiled here with the library's nvcc flags).  The unsplit
  instantiations' CTAs per SM, registers and local bytes
  (``sa_kernel.occupancy``) equal those pinned below from an NVIDIA
  H100 80GB HBM3; the split ones hold as many CTAs per SM in at most 48
  registers.  The figures are printed (``-s``).

On the card's host, which has no JAX (that ``tests/conftest.py``
imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_restart_split_card.py
"""

import json
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch.ops import sa_kernel
from cuda_satabsearch_tpu_torch.ops.common import round8
from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig
from satbench import deploy

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
CONFIG14291 = Path(__file__).resolve().parent.parent / "satbench" / \
    "configs" / "astral14291_r4096.json"
SEED = 2 ** 31 - 11
# the unsplit kernel per (widest bucket d2, n1r): (CTAs per SM,
# registers, local bytes) at c_par 128 with LSOLN off and on, as the
# kernel reads on an NVIDIA H100 80GB HBM3
PINNED_OCCUPANCY = {
    (32, 8): ((10, 48, 0), (10, 48, 0)),
    (32, 16): ((10, 48, 0), (10, 48, 0)),
    (32, 24): ((10, 48, 0), (10, 48, 0)),
    (32, 32): ((10, 48, 0), (10, 48, 0)),
    (32, 40): ((10, 48, 16), (10, 48, 16)),
    (32, 56): ((10, 48, 16), (8, 48, 16)),
    (32, 72): ((7, 48, 16), (6, 48, 16)),
    (32, 104): ((4, 48, 16), (3, 48, 16)),
    (32, 128): ((3, 48, 16), (2, 48, 16)),
    (80, 8): ((10, 47, 0), (10, 47, 0)),
    (80, 16): ((9, 47, 0), (9, 47, 0)),
    (80, 24): ((9, 47, 0), (8, 47, 0)),
    (80, 32): ((8, 47, 0), (7, 47, 0)),
    (80, 40): ((7, 47, 32), (6, 47, 32)),
    (80, 56): ((6, 47, 32), (5, 47, 32)),
    (80, 72): ((5, 47, 32), (4, 47, 32)),
    (80, 104): ((3, 47, 32), (2, 47, 32)),
    (80, 128): ((2, 47, 32), (2, 47, 32)),
    (112, 8): ((5, 47, 0), (5, 47, 0)),
    (112, 16): ((5, 47, 0), (5, 47, 0)),
    (112, 24): ((5, 47, 0), (4, 47, 0)),
    (112, 32): ((5, 47, 0), (4, 47, 0)),
    (112, 40): ((4, 47, 32), (4, 47, 32)),
    (112, 56): ((4, 47, 32), (3, 47, 32)),
    (112, 72): ((3, 47, 32), (3, 47, 32)),
    (112, 104): ((2, 47, 32), (2, 47, 32)),
    (112, 128): ((2, 47, 32), (1, 47, 32)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="module")
def db14291(tmp_path_factory):
    """The 14,291-entry DB file of ``astral14291_r4096`` for SEED."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    config = json.loads(CONFIG14291.read_text())
    assert config["db"]["entries"] == 14291
    return str(deploy.prepare("astral14291_r4096", config, SEED,
                              tmp_path_factory.mktemp("cache")).path)


def count_replays(sess) -> list:
    """The session's graph replays, counted through its capture seam
    (ops/search.Searcher.capture)."""
    replays, capture = [], sess.searcher.capture

    def counted(fn):
        replay = capture(fn)
        return lambda: replays.append(replay())
    sess.searcher.capture = counted
    return replays


def width16(sess, n):
    """The first n DB entries of 9-16 SSEs (round8 width 16)."""
    names = [nm for nm, o in zip(sess.db.names, sess.db.orders)
             if round8(int(o)) == 16][:n]
    assert len(names) == n
    return [sess.resolve_query(nm) for nm in names]


@pytest.mark.parametrize("lsoln", [False, True])
@pytest.mark.parametrize(
    "maxstart, db",
    [(4096, "astral586"), (256, "astral586"), (4096, "astral14291"),
     (256, "astral14291")],
    ids=["4096", "256", "4096-astral14291", "256-astral14291"])
def test_a_split_query_equals_its_row_of_an_unsplit_list(card, request,
                                                         maxstart, db, lsoln):
    path = DB586 if db == "astral586" else request.getfixturevalue("db14291")
    sess = SearchSession(path, SessionConfig(maxstart=maxstart, seed=SEED))
    sess.searcher.capture = None  # eager: the list and the searches alike
    plan = sess.device_db[0]
    r_seq = maxstart // 128
    split = sa_kernel.restart_split(plan, 1, 16, c_par=128, r_seq=r_seq,
                                    lsoln=lsoln)
    assert split > 1
    assert sa_kernel.restart_split(plan, 64, 16, c_par=128, r_seq=r_seq,
                                   lsoln=lsoln) == 1
    qs = width16(sess, 64)
    before = sa_search.launches, sa_search.split_launches
    listed = sess.search_many(qs, lsoln=lsoln)  # tags 0..63
    assert (sa_search.launches - before[0],
            sa_search.split_launches - before[1]) == (2, 0)
    picks = (0, 17, 40, 63)
    before = sa_search.launches, sa_search.split_launches
    for k in picks:
        alone = sess.search(qs[k], lsoln=lsoln, query_tag=k)
        np.testing.assert_array_equal(alone.scores, listed[k].scores)
        if lsoln:
            for a, b in zip(alone.ssemaps, listed[k].ssemaps):
                np.testing.assert_array_equal(a, b)
        else:
            assert alone.ssemaps is None
    n = 2 * len(picks)
    assert (sa_search.launches - before[0],
            sa_search.split_launches - before[1]) == (n, n)
    print(f"\n{card}: {db}, r = {maxstart}, LSOLN {lsoln}: {len(picks)} "
          f"queries split {split} ways == their rows of a 64-query list "
          "(unsplit)", end="")


@pytest.mark.parametrize("lsoln", [False, True])
def test_split_replays_equal_eager_searches(card, lsoln):
    cfg = SessionConfig(maxstart=4096, seed=SEED)
    sess, eager = (SearchSession(DB586, cfg) for _ in range(2))
    eager.searcher.capture = None
    assert sess.searcher.capture is not None
    firsts = {}
    for i, o in enumerate(sess.db.orders):
        firsts.setdefault(round8(int(o)), sess.db.names[i])
    replays = count_replays(sess)
    for width, name in sorted(firsts.items())[:4]:
        q = sess.resolve_query(name)
        ref = eager.search(q, lsoln=lsoln, query_tag=700 + width)
        for _ in range(4):  # eager, eager and capture, replay, replay
            before = sa_search.split_launches
            got = sess.search(q, lsoln=lsoln, query_tag=700 + width)
            assert sa_search.split_launches - before == 2
            np.testing.assert_array_equal(got.scores, ref.scores)
            if lsoln:
                for a, b in zip(got.ssemaps, ref.ssemaps):
                    np.testing.assert_array_equal(a, b)
    assert len(replays) == 2 * 4


def test_instantiations_keep_their_resources(card, tmp_path):
    log = subprocess.run(
        [sa_kernel.find_nvcc(), *sa_kernel.NVCC_FLAGS, "-c", "-o",
         str(tmp_path / "sa_search.o"), str(sa_kernel.SOURCES[0])],
        capture_output=True, text=True, check=True)
    ptxas = log.stdout + log.stderr
    regs = re.findall(r"sa_plan_kernelILi(\d)ELi(\d)ELb(\d)ELi1E.*?\n.*?"
                      r"(\d+) bytes spill stores, (\d+) bytes spill loads"
                      r".*?\n.*?Used (\d+) registers", ptxas)
    print(f"\n{card}: ptxas (EW, QW, split, spill stores, loads, "
          f"registers) at one lane per chain: {regs}", end="")
    assert len(regs) == 8
    assert all(r[3:5] == ("0", "0") and int(r[5]) <= 48 for r in regs)
    sa_kernel.prepare(torch.device("cuda", 0))
    for (d2, n1r), want in sorted(PINNED_OCCUPANCY.items()):
        for lsoln in (False, True):
            unsplit = sa_kernel.occupancy(d2, n1r, 128, lsoln)
            split = sa_kernel.occupancy(d2, n1r, 128, lsoln, split=True)
            print(f"\n{card}: d2 {d2:3d} n1r {n1r:3d} LSOLN {lsoln:d}: "
                  f"unsplit {unsplit} (pinned {want[lsoln]}), split {split}",
                  end="")
            assert unsplit == want[lsoln]
            assert split[0] == unsplit[0] and split[1] <= 48
            assert split[2] == unsplit[2]
