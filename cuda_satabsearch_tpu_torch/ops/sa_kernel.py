"""Wrapper of the CUDA SA search kernel (csrc/sa_search.cu).

Replaces cuda_satabsearch_tpu/ops/pallas_sa2.py
``make_pallas2_bucket_search`` (kernel :535, pallas_call :1163).  The
kernel is CUDA C++ for sm_90a, compiled with nvcc at first launch from
the package's own sources into one library in
``cuda_satabsearch_tpu_torch/_build/`` (keyed by a hash of the sources
and flags), together with the start-up kernel of csrc/warmup.cu
(core/warmup.py), one nvcc process per source started together and
one link, and bound through ctypes with plain C entry points.
Nothing is built or imported from the CUDA toolkit when this module is
imported.  ``prepare`` loads the kernel's module and sets its
shared-memory limit once per device (the start-up does it ahead of the
first search; otherwise the first launch on a device does).

``sa_search`` searches K queries against a launch plan
(ops/kernel_search.make_plan: a shard's buckets in at most two launch
classes).  A plan on the CPU goes to the plain version
(ops/engine.search_plan_plain); on a CUDA device each launch class is
one kernel launch, the wide class on a side stream forked from the
current one and joined back by an event, or the call raises.
``sa_search.launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core.constants import DEFAULTS, SAParams
from .common import C_MAX, slots_per_restart
from .engine import search_plan_plain
from .rng import M32

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sa_search.cu", _PKG / "csrc" / "warmup.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_BUCKETS = 8  # buckets of one launch (csrc/sa_search.cu MAX_BUCKETS)

_P, _I = ctypes.c_void_p, ctypes.c_int


class BucketDesc(ctypes.Structure):
    """csrc/sa_search.cu BucketDesc: one bucket of a launch."""
    _fields_ = [("types", _P), ("tab", _P), ("dmat", _P), ("n2", _P),
                ("index", _P), ("d2", _I), ("E", _I), ("first", _I),
                ("out", _I)]


class PlanDesc(ctypes.Structure):
    """csrc/sa_search.cu PlanDesc, passed to the kernel by value."""
    _fields_ = [("b", BucketDesc * MAX_BUCKETS), ("nb", _I)]


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas registers / shared memory / spills)
    # device index -> its dynamic shared-memory limit, once prepared
    smem_limit: dict = field(default_factory=dict)


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the SA kernel is built from csrc/ at first launch")


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"kernels_{digest}.so"
    build_s, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [so.with_name(f"{s.stem}_{digest}.{os.getpid()}.o")
                for s in SOURCES]
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        outs = [(p.communicate()[0], p.returncode) for p in procs]
        log = "".join(text for text, _ in outs)
        if any(rc != 0 for _, rc in outs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *(str(o) for o in objs)],
                             capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        for o in objs:
            o.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so))
    P, I, F = _P, _I, ctypes.c_float
    lib.sa_search_launch.argtypes = [
        ctypes.POINTER(PlanDesc), I,  # plan, d2max
        P, P, P, P, I, I,  # qtypes, qtab, qdmat, n1s, K, n1r
        ctypes.c_uint32, P, P, I,  # seed, tags, uniforms, ecols
        I, I, I, I,  # c_par, r_seq, lorder, lsoln
        I, F, F, F, F, F, I,  # SAParams
        P, P, P]  # out_scores, out_maps, stream
    lib.sa_search_launch.restype = I
    lib.sa_search_prepare.argtypes = [I]  # device_max_smem
    lib.sa_search_prepare.restype = I
    lib.sa_search_smem_bytes.argtypes = [I, I, I, I]
    lib.sa_search_smem_bytes.restype = ctypes.c_size_t
    lib.sa_search_occupancy.argtypes = [I, I, I, I, P, P, P]
    lib.sa_search_occupancy.restype = I
    lib.sa_search_error_string.argtypes = [I]
    lib.sa_search_error_string.restype = ctypes.c_char_p
    lib.add_one_launch.argtypes = [P, P, I, P]  # x, out, n, stream
    lib.add_one_launch.restype = I
    return Library(lib=lib, path=so, build_s=build_s, log=log)


def device_guard(dev: torch.device):
    """The guard a launch on CUDA device ``dev`` needs: none when ``dev``
    is already the current device."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def cuda_error(what: str, err: int) -> RuntimeError:
    """The error to raise for a failed CUDA call of the library."""
    return RuntimeError(f"{what} failed: " + load_library().lib
                        .sa_search_error_string(err).decode())


def prepare(dev: torch.device) -> int:
    """Load the SA kernel's module on CUDA device ``dev`` and allow it
    the device's opt-in dynamic shared memory, once per device; returns
    that limit in bytes."""
    library = load_library()
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in library.smem_limit:
        limit = torch.cuda.get_device_properties(
            idx).shared_memory_per_block_optin
        with torch.cuda.device(idx):
            err = library.lib.sa_search_prepare(limit)
        if err != 0:
            raise cuda_error("SA kernel prepare", err)
        library.smem_limit[idx] = limit
    return library.smem_limit[idx]


def occupancy(d2max: int, n1r: int, c_par: int, lsoln: bool
              ) -> tuple[int, int, int]:
    """(CTAs per SM, registers per thread, local bytes per thread) of the
    kernel instantiation that runs a launch class whose widest bucket is
    ``d2max`` (on the current device, after ``prepare``)."""
    out = [ctypes.c_int() for _ in range(3)]
    err = load_library().lib.sa_search_occupancy(
        d2max, n1r, c_par, int(lsoln), *(ctypes.byref(o) for o in out))
    if err != 0:
        raise cuda_error("SA kernel occupancy query", err)
    return tuple(o.value for o in out)


@functools.lru_cache(maxsize=None)
def launch_streams(index: int):
    """(side stream, fork event, join event) of CUDA device ``index``:
    a plan's wide class runs on the side stream, forked from and joined
    back to the current stream."""
    with torch.cuda.device(index):
        return torch.cuda.Stream(), torch.cuda.Event(), torch.cuda.Event()


def upload_tags(tags, dev: torch.device) -> torch.Tensor:
    """Query tags as the kernel takes them: int32[K] on ``dev`` holding
    the uint32 value tag & 0xffffffff."""
    bits = (np.asarray(tags, np.int64).reshape(-1) & M32).astype(np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(dev)


def check_tensor(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def descriptor(cls) -> PlanDesc:
    """The kernel's descriptor of a launch class, built once and kept on
    the class (its buckets' tensors stay resident)."""
    if cls.desc is None:
        desc = PlanDesc(nb=len(cls.buckets))
        first = 0
        for i, (b, out) in enumerate(cls.buckets):
            E = len(b.index)
            desc.b[i] = BucketDesc(
                b.types.data_ptr(), b.tab.data_ptr(), b.dmat.data_ptr(),
                b.n2.data_ptr(), b.index_dev.data_ptr(), b.dim, E, first,
                out)
            first += E
        cls.desc = desc
    return cls.desc


def sa_search(qtypes, qtab, qdmat, n1s, plan, *, seed: int = 0, tags=None,
              uniforms=None, c_par: int, r_seq: int, lorder: bool,
              lsoln: bool, params: SAParams = DEFAULTS):
    """SA search of K queries (qtypes int8[K, n1r], qtab uint8[K, n1r,
    n1r], qdmat f32[K, n1r, n1r], n1s int32[K]) against every entry of
    ``plan``; the arguments and results of ops/engine.search_plan_plain.
    The stream is drawn in-kernel from ``seed``, ``tags`` (a sequence, or
    int32[K] from ``upload_tags``) and each entry's file-order index, or
    read from ``uniforms`` f32[K, E, r_seq, P, c_par].  On the CPU the
    plain version runs; on a CUDA device one kernel launch per launch
    class (at most two) is made.  Returns (scores int32[K, E], maps
    int32[K, E, n1r] or None), E = plan.nentries in the plan's order."""
    dev = plan.device
    if dev.type == "cpu":
        return search_plan_plain(qtypes, qtab, qdmat, n1s, plan, seed=seed,
                                 tags=tags, uniforms=uniforms, c_par=c_par,
                                 r_seq=r_seq, lorder=lorder, lsoln=lsoln,
                                 params=params)
    if dev.type != "cuda":
        raise ValueError(f"no SA kernel for device {dev}")
    if (tags is None) == (uniforms is None):
        raise ValueError("give exactly one of tags / uniforms")
    if not 1 <= c_par <= C_MAX:
        raise ValueError(f"c_par must be in [1, {C_MAX}], got {c_par}")
    K, n1r = qtypes.shape
    E = plan.nentries
    P = slots_per_restart(n1r, params.maxiter)
    check_tensor("qtypes", qtypes, torch.int8, (K, n1r), dev)
    check_tensor("qtab", qtab, torch.uint8, (K, n1r, n1r), dev)
    check_tensor("qdmat", qdmat, torch.float32, (K, n1r, n1r), dev)
    check_tensor("n1s", n1s, torch.int32, (K,), dev)
    if uniforms is not None:
        check_tensor("uniforms", uniforms, torch.float32,
                     (K, E, r_seq, P, c_par), dev)
    elif not torch.is_tensor(tags):
        tags = upload_tags(tags, dev)
    else:
        check_tensor("tags", tags, torch.int32, (K,), dev)
    scores = torch.empty((K, E), dtype=torch.int32, device=dev)
    maps = (torch.empty((K, E, n1r), dtype=torch.int32, device=dev)
            if lsoln else None)
    if K == 0 or E == 0:
        return scores, maps
    limit = prepare(dev)
    lib = load_library().lib
    for cls in plan.classes:
        smem = lib.sa_search_smem_bytes(n1r, cls.d2max, c_par, int(lsoln))
        if smem > limit:
            raise ValueError(f"SA kernel needs {smem} B of shared memory at "
                             f"n1r={n1r}, d2={cls.d2max}; the device "
                             f"allows {limit}")
    p = params
    args = (qtypes.data_ptr(), qtab.data_ptr(), qdmat.data_ptr(),
            n1s.data_ptr(), K, n1r, seed & M32,
            tags.data_ptr() if uniforms is None else None,
            uniforms.data_ptr() if uniforms is not None else None, E,
            c_par, r_seq, int(lorder), int(lsoln), p.maxiter, p.temp0,
            p.alpha, p.mxssed, p.init_matchprob, p.eps, p.maxscore_init,
            scores.data_ptr(), maps.data_ptr() if maps is not None else None)

    def launch(cls, stream):
        err = lib.sa_search_launch(ctypes.byref(descriptor(cls)), cls.d2max,
                                   *args, stream.cuda_stream)
        if err != 0:
            raise cuda_error("SA kernel launch", err)
        sa_search.launches += 1

    with device_guard(dev):
        current = torch.cuda.current_stream(dev)
        if len(plan.classes) == 1:
            launch(plan.classes[0], current)
        else:  # the wide class on the side stream: both classes together
            side, fork, join = launch_streams(current.device_index)
            fork.record(current)
            side.wait_event(fork)
            launch(plan.classes[0], side)
            launch(plan.classes[1], current)
            join.record(side)
            current.wait_event(join)
    return scores, maps


sa_search.launches = 0
