"""On the card (skipped elsewhere): the SA kernel's lanes per chain.

* Lane launches equal one-lane launches bit for bit: queries of 8, 19
  and 101 SSEs against the 586-entry DB (both launch classes, 128 chains
  of one restart), LORDER and LSOLN true and false, in-kernel draws and
  a supplied stream, G = 2 and 4 lanes per chain in both classes and
  the pair the rule gives a long query (wide 4, narrow 2;
  ``sa_kernel.chain_lanes`` stubbed to give it) against G = 1: scores,
  and maps under LSOLN.  Among 128 chains of one restart many reach an
  entry's max with other maps, so the first maximal chain decides the
  map; a 3-SSE query at 5 moves a restart adds entries where most
  chains tie.  ``sa_search.lane_launches`` counts the launches with
  G > 1 and nothing else.
* The rule on this card: one query at r = 128 runs its wide class on 4
  lanes and, from n1r 24, its narrow class on 2; a 64-query tile and
  one query at r = 4096 (split) run without.
* ptxas reports no spill for any lane instantiation; their CTAs per
  SM, registers and local bytes (``sa_kernel.occupancy``) are printed
  (``-s``).

On the card's host, which has no JAX (that ``tests/conftest.py``
imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_chain_lanes_card.py
"""

import dataclasses
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS
from cuda_satabsearch_tpu_torch.io.pack import pack_query
from cuda_satabsearch_tpu_torch.ops import rng, sa_kernel
from cuda_satabsearch_tpu_torch.ops.common import round8, slots_per_restart
from cuda_satabsearch_tpu_torch.ops.kernel_search import pack_queries
from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig
from cuda_satabsearch_tpu_torch.synthetic import random_entry

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
SEED = 2 ** 31 - 13


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="module")
def plan(card):
    sess = SearchSession(DB586, SessionConfig(maxstart=128, seed=SEED))
    (plan,) = sess.device_db
    assert [cls.d2max > 32 for cls in plan.classes] == [True, False]
    return plan


def query(n1, dev):
    q = pack_query(random_entry(np.random.default_rng(n1), n1, f"q{n1}"))
    return pack_queries([q], round8(n1), dev)


def search(q, plan, lanes, monkeypatch, **kw):
    monkeypatch.setattr(sa_kernel, "chain_lanes", lambda *a, **k: lanes)
    before = sa_search.launches, sa_search.lane_launches
    out = sa_search(*q, plan, c_par=128, r_seq=1, **kw)
    torch.cuda.synchronize()
    assert (sa_search.launches - before[0],
            sa_search.lane_launches - before[1]) == (
                2, sum(g > 1 for g in lanes))
    return out


def assert_lanes_equal_one_lane(q, plan, monkeypatch, lsoln, **kw):
    ref = search(q, plan, (1, 1), monkeypatch, lsoln=lsoln, **kw)
    for lanes in [(g, g) for g in sa_kernel.LANES[1:]] + [(4, 2)]:
        got = search(q, plan, lanes, monkeypatch, lsoln=lsoln, **kw)
        assert torch.equal(got[0], ref[0]), lanes
        if lsoln:
            assert torch.equal(got[1], ref[1]), lanes
        else:
            assert got[1] is None


@pytest.mark.parametrize("supplied", [False, True])
@pytest.mark.parametrize("lsoln", [True, False])
@pytest.mark.parametrize("lorder", [True, False])
@pytest.mark.parametrize("n1", [8, 19, 101])
def test_lanes_equal_one_lane(plan, monkeypatch, n1, lorder, lsoln,
                              supplied):
    dev = plan.device
    q = query(n1, dev)
    if supplied:
        keys = rng.entry_keys(SEED, [n1], plan.index, device=dev)
        u = rng.make_uniforms(keys, 1, slots_per_restart(round8(n1)), 128,
                              round8(n1))
        kw = dict(uniforms=u.contiguous())
    else:
        kw = dict(seed=SEED, tags=[n1])
    assert_lanes_equal_one_lane(q, plan, monkeypatch, lsoln, lorder=lorder,
                                **kw)


def test_lanes_keep_the_first_maximal_chain(plan, monkeypatch):
    """A 3-SSE query and 5 moves a restart: most chains reach each
    entry's max, with other maps."""
    q = query(3, plan.device)
    params = dataclasses.replace(DEFAULTS, maxiter=5)
    for tag in range(4):
        assert_lanes_equal_one_lane(q, plan, monkeypatch, True, lorder=True,
                                    seed=SEED, tags=[tag], params=params)


def test_the_rule_on_this_card(card, plan):
    lanes = {n1r: sa_kernel.launch_shape(plan, 1, n1r, c_par=128, r_seq=1,
                                         lsoln=True)[1]
             for n1r in (8, 16, 24, 56)}
    tile = sa_kernel.launch_shape(plan, 64, 16, c_par=128, r_seq=1,
                                  lsoln=True)
    split = sa_kernel.launch_shape(plan, 1, 16, c_par=128, r_seq=32,
                                   lsoln=False)
    print(f"\n{card}: lanes (wide, narrow) of one 586-entry query at "
          f"r = 128, LSOLN, by n1r: {lanes}; a 64-query tile {tile}; one "
          f"query at r = 4096 (S, lanes) {split}", end="")
    assert all(g[0] == 4 for g in lanes.values())
    assert lanes[24][1] == lanes[56][1] == 2
    assert tile == (1, (1, 1))
    assert split[0] > 1 and split[1] == (1, 1)


def test_lane_instantiations_do_not_spill(card, tmp_path):
    log = subprocess.run(
        [sa_kernel.find_nvcc(), *sa_kernel.NVCC_FLAGS, "-c", "-o",
         str(tmp_path / "sa_search.o"), str(sa_kernel.SOURCES[0])],
        capture_output=True, text=True, check=True)
    ptxas = log.stdout + log.stderr
    found = re.findall(r"sa_plan_kernelILi(\d)ELi(\d)ELb(\d)ELi(\d)E.*?\n.*?"
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads"
                       r".*?\n.*?Used (\d+) registers", ptxas)
    lanes = [r for r in found if r[3] != "1"]
    print(f"\n{card}: ptxas (EW, QW, split, G, spill stores, loads, "
          f"registers): {lanes}", end="")
    assert len(lanes) == 8
    assert all(r[2] == "0" and r[4:6] == ("0", "0") for r in lanes)
    sa_kernel.prepare(torch.device("cuda", 0))
    for d2 in (32, 112):
        for n1r in (8, 16, 56, 104):
            got = {g: sa_kernel.occupancy(d2, n1r, 128, True, lanes=g)
                   for g in sa_kernel.LANES}
            print(f"\n{card}: d2 {d2:3d} n1r {n1r:3d} LSOLN: (CTAs per SM, "
                  f"registers, local bytes) by G {got}", end="")
            assert all(o[0] > 0 for o in got.values())
