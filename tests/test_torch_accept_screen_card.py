"""On the card (skipped elsewhere): the SA kernel's screened Metropolis
test (csrc/sa_search.cu).

* fast_ln over all 2**23 values of the uniform grid u = k 2**-23, the
  kernel's own function built here from its source: the largest
  |fast_ln(u) - ln u| (ln u from ``ops/rng.ln_f32`` on the card) is
  within ``sa_kernel.FAST_LN_ERR``, and fast_ln(0) = -inf.  The error
  is printed (``-s``).  The table of exact logs that the kernel reads
  (``sa_kernel.ln_grid``) equals ``ops/rng.ln_f32`` of the grid bit for
  bit.
* The kernel with in-kernel draws equals the plain plan bit for bit,
  scores and maps: a plan of both launch classes with padding rows, at
  r = 128 (128 chains x 1 restart) at G = 1, 2 and 4 lanes per chain
  and with 100 chains (partial warps) at G = 1 and 4, and at r = 4096
  (128 x 32) unsplit and split 4 ways (``sa_kernel.launch_shape``
  stubbed), LSOLN on and off.
* With a margin that leaves every move in doubt, every screened
  warp-move takes the exact log (``exact_log_share`` 1) and the result
  is the same; with temp0 = 0 nothing is screened (no counter moves)
  and the result is the plain plan's.
* ``sa_search.exact_log_share`` over 586-entry searches at r = 128 and
  r = 4096 is under 0.1 % and above 0 (the exact path runs); a CUDA
  graph's capture and replays move neither of its counts.
* The SASS of every instantiation branches around the exact path: it
  issues no double-precision instruction, holds one VOTE.ANY into a
  predicate, followed by a conditional branch, and the exact path's
  table load and counter update lie between that branch and its target,
  so a move that no lane of the warp doubts issues none of them.

On the card's host, which has no JAX (that ``tests/conftest.py``
imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_accept_screen_card.py
"""

import ctypes
import dataclasses
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS
from cuda_satabsearch_tpu_torch.io.pack import pack_database, pack_query
from cuda_satabsearch_tpu_torch.ops import rng, sa_kernel
from cuda_satabsearch_tpu_torch.ops.common import round8
from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
from cuda_satabsearch_tpu_torch.ops.kernel_search import (
    make_plan, pack_queries, prepare_bucket)
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (exact_log_counts,
                                                      exact_log_share,
                                                      sa_search)
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig
from cuda_satabsearch_tpu_torch.synthetic import random_entry

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")
SEED = 2 ** 31 - 17

GRID = """
#include "{source}"
__global__ void fast_ln_grid(float* out, int n) {{
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = fast_ln(static_cast<float>(k) * 0x1p-23f);
}}
extern "C" int fast_ln_grid_launch(float* out, int n) {{
  fast_ln_grid<<<(n + 255) / 256, 256>>>(out, n);
  return static_cast<int>(cudaDeviceSynchronize());
}}
"""


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plan(dev):
    """Random entries of 2-111 SSEs in 6 buckets of both launch classes,
    padded to 3 rows a bucket."""
    r = np.random.default_rng(19)
    entries = [random_entry(r, int(n), f"e{i}") for i, n in enumerate(
        (3, 7, 12, 15, 20, 30, 31, 40, 47, 70, 90, 111))]
    db = pack_database(entries, pad_to=3)
    plan = make_plan([prepare_bucket(b, dev) for b in db.buckets])
    assert len(plan.classes) == 2
    return plan


def queries(dev, *n1s):
    r = np.random.default_rng(sum(n1s))
    qs = [pack_query(random_entry(r, n, f"q{n}")) for n in n1s]
    return pack_queries(qs, round8(max(n1s)), dev)


def search_both(q, plan, monkeypatch, shape, **kw):
    """(kernel, plain plan) results of one search at the launch shape
    ``shape`` (S, lanes per class)."""
    monkeypatch.setattr(sa_kernel, "launch_shape", lambda *a, **k: shape)
    got = sa_search(*q, plan, **kw)
    torch.cuda.synchronize()
    return got, search_plan_plain(*q, plan, **kw)


def assert_equal(got, ref, lsoln):
    assert torch.equal(got[0], ref[0])
    if lsoln:
        assert torch.equal(got[1], ref[1])
    else:
        assert got[1] is None and ref[1] is None


def test_fast_ln_error_on_the_uniform_grid(dev, tmp_path):
    cu = tmp_path / "fast_ln_grid.cu"
    cu.write_text(GRID.format(source=sa_kernel.SOURCES[0]))
    so = tmp_path / "fast_ln_grid.so"
    subprocess.run([sa_kernel.find_nvcc(), *sa_kernel.NVCC_FLAGS, "-shared",
                    "-o", str(so), str(cu)], capture_output=True, check=True)
    lib = ctypes.CDLL(str(so))
    lib.fast_ln_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n = 2 ** 23
    out = torch.empty(n, dtype=torch.float32, device=dev)
    assert lib.fast_ln_grid_launch(out.data_ptr(), n) == 0
    u = torch.arange(n, dtype=torch.float64, device=dev).mul_(2.0 ** -23)
    exact = rng.ln_f32(u.float())
    assert out[0].item() == -np.inf and exact[0].item() == -np.inf
    sa_kernel.prepare(dev)
    assert torch.equal(sa_kernel.LN_GRIDS[dev.index], exact)
    err = (out[1:].double() - exact[1:].double()).abs()
    worst = int(err.argmax()) + 1
    E = err.max().item()
    print(f"\n{torch.cuda.get_device_name(0)}: fast_ln over {n - 1} grid "
          f"values: max |fast_ln - ln u| {E:.4e} = 2**{np.log2(E):.3f} at u "
          f"= {worst} * 2**-23 (FAST_LN_ERR 2**"
          f"{np.log2(sa_kernel.FAST_LN_ERR):.0f}); mean {err.mean():.3e}",
          end="")
    assert E <= sa_kernel.FAST_LN_ERR


@pytest.mark.parametrize("lsoln", [True, False])
@pytest.mark.parametrize("c_par, shape", [
    (128, (1, (1, 1))), (128, (1, (2, 2))), (128, (1, (4, 4))),
    (128, (1, (4, 2))), (100, (1, (1, 1))), (100, (1, (4, 4)))])
def test_r128_equals_the_plain_plan(dev, plan, monkeypatch, c_par, shape,
                                    lsoln):
    q = queries(dev, 13, 16)
    got, ref = search_both(q, plan, monkeypatch, shape, seed=SEED,
                           tags=[3, 2 ** 31 + 5], c_par=c_par, r_seq=1,
                           lorder=True, lsoln=lsoln)
    assert_equal(got, ref, lsoln)


@pytest.mark.parametrize("lsoln", [True, False])
@pytest.mark.parametrize("split", [1, 4])
def test_r4096_equals_the_plain_plan(dev, plan, monkeypatch, split, lsoln):
    q = queries(dev, 19)
    got, ref = search_both(q, plan, monkeypatch, (split, (1, 1)), seed=SEED,
                           tags=[11], c_par=128, r_seq=32, lorder=True,
                           lsoln=lsoln)
    assert_equal(got, ref, lsoln)


def test_every_move_in_doubt_takes_the_exact_log(dev, plan, monkeypatch):
    monkeypatch.setattr(sa_kernel, "SCREEN_MARGIN", 2.0 ** 12)
    q = queries(dev, 13, 16)
    before = exact_log_counts()
    got, ref = search_both(q, plan, monkeypatch, (1, (4, 1)), seed=SEED,
                           tags=[7, 8], c_par=100, r_seq=2, lorder=True,
                           lsoln=True)
    assert_equal(got, ref, True)
    assert exact_log_share(before) == 1.0


def test_temp0_0_is_not_screened(dev, plan, monkeypatch):
    params = dataclasses.replace(DEFAULTS, temp0=0.0)
    assert not sa_kernel.screens(params)
    q = queries(dev, 8)
    before = exact_log_counts()
    for shape in ((1, (1, 1)), (1, (4, 4))):
        got, ref = search_both(q, plan, monkeypatch, shape, seed=SEED,
                               tags=[1], c_par=128, r_seq=1, lorder=True,
                               lsoln=True, params=params)
        assert_equal(got, ref, True)
    assert exact_log_counts() == before


@pytest.mark.parametrize("maxstart, n", [(128, 24), (4096, 3)])
def test_exact_log_share_on_586_entries(dev, maxstart, n):
    sess = SearchSession(DB586, SessionConfig(maxstart=maxstart, seed=SEED))
    qs = [sess.resolve_query(nm) for nm in sess.db.names[::586 // n][:n]]
    before = exact_log_counts()
    for q in qs:
        sess.search(q, lorder=True, lsoln=maxstart == 128)
    share = exact_log_share(before)
    exact, screened = (a - b for a, b in zip(exact_log_counts(), before))
    print(f"\n{torch.cuda.get_device_name(0)}: r = {maxstart}, {n} queries "
          f"vs 586 entries: {exact} of {screened} screened warp-moves took "
          f"the exact log, sa_search.exact_log_share {100 * share:.4f} %",
          end="")
    assert 0 < share < 1e-3


def test_graph_captures_and_replays_count_nothing(dev):
    """A key's first and second searches run eagerly and count alike
    (the second then captures its step as a CUDA graph, which counts
    nothing); the third replays the graph, and neither count moves
    (``exact_log_share`` covers the wrapper's own launches)."""
    sess = SearchSession(DB586, SessionConfig(maxstart=128, seed=SEED))
    assert sess.searcher.capture is not None
    q = sess.resolve_query(sess.db.names[0])
    counts = [exact_log_counts()]
    for _ in range(3):
        sess.search(q, lorder=True, lsoln=True)
        counts.append(exact_log_counts())
    assert len(sess.searcher.graphs) == 1
    screened = [b[1] - a[1] for a, b in zip(counts, counts[1:])]
    assert screened[0] > 0 and screened[1] == screened[0]
    assert counts[3] == counts[2]


def test_the_exact_log_is_branched_around(dev, tmp_path):
    obj = tmp_path / "sa_search.o"
    subprocess.run([sa_kernel.find_nvcc(), *sa_kernel.NVCC_FLAGS, "-c", "-o",
                    str(obj), str(sa_kernel.SOURCES[0])],
                   capture_output=True, check=True)
    cuobjdump = os.path.join(os.path.dirname(sa_kernel.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    kernels = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
               if "sa_plan_kernelILi" in f.split("\n", 1)[0]]
    assert len(kernels) == 16
    for f in kernels:
        name = re.search(r"sa_plan_kernelILi\d+ELi\d+ELb\dELi\dE", f).group()
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", f)]
        votes = [i for i, (_, t) in enumerate(ins)
                 if re.search(r"VOTE\.ANY P\d", t)]
        assert len(votes) == 1, name
        at, branch = next((a, t) for a, t in ins[votes[0] + 1:]
                          if re.search(r"\bBRA\b", t))
        assert branch.startswith("@"), (name, branch)
        target = int(branch.split()[-1], 16)
        inside = [t for a, t in ins if at < a < target]
        print(f"\n{name}: VOTE.ANY, then {branch} at {at:#x} over "
              f"{len(inside)} instructions", end="")
        assert any("LDG" in t for t in inside), name
        assert any(re.search(r"\b(RED|ATOM)", t) for t in inside), name
        assert not any(re.search(r"\b(DFMA|DADD|DMUL|F2F\.F64)", t)
                       for _, t in ins), name
