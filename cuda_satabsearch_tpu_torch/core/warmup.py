"""Start-up kernel: bring up the CUDA context and the kernel library.

Counterpart of cuda_satabsearch_tpu/core/warmup.py (``warm_backend``,
its one-op Pallas kernel :48-51), which ran once to open the TPU's
compile session.  Here the same one-op kernel, o = x + 1 on f32[8, 128]
(csrc/warmup.cu, built into the library of ops/sa_kernel.py), is
launched once when a search session starts, so the CUDA context and the
kernel library (built with nvcc at first use) are brought up before the
first search, and its time is reported on stderr.

``add_one`` runs the plain version (x + 1) on CPU tensors and launches
the kernel on CUDA tensors, or raises.  ``add_one.launches`` counts
kernel launches.
"""

from __future__ import annotations

import sys
import time

import torch

from ..ops.sa_kernel import check_tensor, load_library

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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.add_one_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                 stream)
    if err != 0:
        raise RuntimeError("start-up kernel launch failed: "
                           + lib.sa_search_error_string(err).decode())
    add_one.launches += 1
    return out


add_one.launches = 0


def warm_backend(device: torch.device, log: bool = True) -> float:
    """Launch the start-up kernel once on ``device`` and check its
    result; returns the wall seconds spent (0.0 on the CPU, where there
    is nothing to bring up)."""
    if device.type == "cpu":
        return 0.0
    t0 = time.perf_counter()
    out = add_one(torch.zeros(SHAPE, dtype=torch.float32, device=device))
    ok = bool((out == 1.0).all())  # drains the launch
    dt = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("start-up kernel returned wrong values")
    if log:
        print(f"# start-up kernel (CUDA context, kernel library load): "
              f"{dt * 1000.0:.1f} ms", file=sys.stderr)
    return dt
