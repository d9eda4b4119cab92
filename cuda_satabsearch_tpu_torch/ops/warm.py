"""Start-up of a search's path on a card, through the search's own code.

``warm_search`` is what core/warmup.py runs after the start-up kernel:
it loads the SA kernel's module and brings up what a search does around
the kernel (ops/kernel_search.py: the staging, the upload, the gather
into file order; ops/sa_kernel.py: a plan's fork and join and whether a
launch screens its Metropolis test), so that a change to any of them is
warmed with it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.constants import DEFAULTS
from ..io.pack import PackedQuery
from .kernel_search import Staging, stage, to_file_order
from .sa_kernel import device_guard, fork_join, prepare, screens

# a one-SSE query: what the start-up stages
WARM_QUERY = PackedQuery(name="warm", order=1,
                         tabhi=np.zeros((1, 1), np.int8),
                         tablo=np.zeros((1, 1), np.int8),
                         types=np.zeros(1, np.int8),
                         dmat=np.zeros((1, 1), np.float32))


def warm_search(device: torch.device) -> tuple[float, float]:
    """Bring up a search's path on CUDA device ``device``: prepare the SA
    kernel's module (ops/sa_kernel.prepare) and decide whether the
    default schedule's launches screen (ops/sa_kernel.screens: its first
    call, ~0.1 ms, would otherwise fall in the first search), then,
    through a search's own code, a one-query group staged in pinned
    memory and uploaded, a plan's fork and join (ops/sa_kernel.fork_join),
    the gather of scores and maps into file order
    (ops/kernel_search.to_file_order: the first use of a kernel loads its
    module), and the wait for them.  Returns the wall seconds of the two
    parts."""
    t0 = time.perf_counter()
    prepare(device)
    screens(DEFAULTS)
    t1 = time.perf_counter()
    staging = Staging(1, 8, pin=True)
    stage(staging, [WARM_QUERY], [0])
    uploaded = staging.buf.to(device, non_blocking=True)
    with device_guard(device):
        fork_join(torch.cuda.current_stream(device), lambda side: None,
                  lambda current: None)
        # one query's scores and maps over more than 16 columns: the
        # kernels a one-query search's gather launches
        to_file_order(torch.arange(32).to(device),
                      [torch.empty(shape, dtype=torch.int32, device=device)
                       for shape in ((1, 32), (1, 32, 8))])
    uploaded[:1].cpu()  # the stream's last copy: the rest is done
    return t1 - t0, time.perf_counter() - t1
