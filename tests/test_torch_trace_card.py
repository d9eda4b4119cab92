"""On the card (skipped elsewhere): the program's spans and the
profiler's CUDA records are on one clock.

Warm 586-entry searches, one at a time, under ``torch.profiler`` with
CUDA activity only (as the benchmark's traced window runs): every
``sa_plan_kernel`` record starts after the ``kernel_search.enqueue`` span
that launched it began.  The searches drain one by one, so the k-th
launches of the device's start order are the k-th enqueue span's.  The
lags are printed (``-s``).  On the card's host, which has no JAX (that
``tests/conftest.py`` imports):

    python3 -m pytest --noconftest -m card -s tests/test_torch_trace_card.py
"""

import os

import numpy as np
import pytest
import torch

from cuda_satabsearch_tpu_torch import trace
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig

pytestmark = pytest.mark.card

DB586 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tableauxdistmatrixdb.small.ascii")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


def test_no_sa_kernel_starts_before_its_enqueue_span(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess = SearchSession(DB586, SessionConfig())
    queries = [sess.resolve_query(n) for n in sess.db.names[::7]]
    for q in queries[:3]:  # warm
        sess.search(q)
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for q in queries:
            sess.search(q)
        torch.cuda.synchronize()
    kernels = sorted(ev.start_ns() for ev in
                     prof.profiler.kineto_results.events()
                     if ev.device_type() == DeviceType.CUDA
                     and "sa_plan_kernel" in ev.name())
    enqueues = sorted(s.start_ns for s in trace.spans()
                      if s.name == "kernel_search.enqueue")
    per = len(sess.device_db[0].classes)
    assert len(enqueues) == len(queries) and per == 2
    assert len(kernels) == per * len(enqueues)
    lags = np.array([k - enqueues[i // per] for i, k in enumerate(kernels)])
    print(f"\n{card}: {len(kernels)} SA launches after {len(enqueues)} "
          f"enqueue spans; lag from the span's start to the kernel's: "
          f"median {np.median(lags) / 1e3:.1f} us, min {lags.min() / 1e3:.1f}"
          f" us, max {lags.max() / 1e3:.1f} us")
    assert lags.min() >= 0
