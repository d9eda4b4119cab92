"""Start-up: bring up the CUDA context, the kernel library and every
kernel the first search launches.

Counterpart of cuda_satabsearch_tpu/core/warmup.py (``warm_backend``,
its one-op Pallas kernel :48-51), which ran once so that the first real
search paid no first-use cost.  Here the same one-op kernel, o = x + 1
on f32[8, 128] (csrc/warmup.cu, built into the library of
ops/sa_kernel.py), is launched once when a search session starts; then
the SA kernel's module is loaded and its shared-memory limit set
(ops/sa_kernel.prepare), and then what a search touches around the
kernel: the query tags' upload (ops/sa_kernel.upload_tags), the side
stream and the fork and join events of a plan's two launch classes
(ops/sa_kernel.launch_streams), and a drain.  The three times are
reported on stderr.

``add_one`` runs the plain version (x + 1) on CPU tensors and launches
the kernel on CUDA tensors, or raises.  ``add_one.launches`` counts
kernel launches.
"""

from __future__ import annotations

import sys
import time

import torch

from ..ops.sa_kernel import (check_tensor, device_guard, launch_streams,
                             load_library, prepare, upload_tags)

SHAPE = (8, 128)  # the JAX package's warm-up block


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for a contiguous float32 tensor: the plain version on the
    CPU, the kernel of csrc/warmup.cu on a CUDA device."""
    dev = x.device
    if dev.type == "cpu":
        return x + 1.0
    if dev.type != "cuda":
        raise ValueError(f"no start-up kernel for device {dev}")
    check_tensor("x", x, torch.float32, x.shape, dev)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library().lib
    with device_guard(dev):
        err = lib.add_one_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("start-up kernel launch failed: "
                           + lib.sa_search_error_string(err).decode())
    add_one.launches += 1
    return out


add_one.launches = 0


def warm_backend(device: torch.device, log: bool = True) -> float:
    """Bring up ``device`` for searching: launch the start-up kernel once
    and check its result, prepare the SA kernel, and bring up the launch
    path of a search (a tags upload, the side stream, a fork and a join,
    a drain).  Returns the wall seconds spent (0.0 on
    the CPU, where there is nothing to bring up)."""
    if device.type == "cpu":
        return 0.0
    t0 = time.perf_counter()
    out = add_one(torch.zeros(SHAPE, dtype=torch.float32, device=device))
    ok = bool((out == 1.0).all())  # drains the launch
    t1 = time.perf_counter()
    if not ok:
        raise RuntimeError("start-up kernel returned wrong values")
    prepare(device)
    t2 = time.perf_counter()
    tags = upload_tags([0], device)
    with device_guard(device):
        current = torch.cuda.current_stream(device)
        side, fork, join = launch_streams(current.device_index)
        fork.record(current)
        side.wait_event(fork)
        join.record(side)
        current.wait_event(join)
    tags.cpu()
    t3 = time.perf_counter()
    if log:
        print(f"# start-up on {device}: CUDA context and kernel library "
              f"{(t1 - t0) * 1e3:.1f} ms, SA module prepare "
              f"{(t2 - t1) * 1e3:.1f} ms, launch path "
              f"{(t3 - t2) * 1e3:.1f} ms", file=sys.stderr)
    return t3 - t0
