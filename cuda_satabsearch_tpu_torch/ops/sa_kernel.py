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

``sa_search`` takes the tensors of ops/engine.search_plain.  Tensors on
the CPU go to that plain version; tensors on a CUDA device launch the
kernel, or raise.  ``sa_search.launches`` counts kernel launches.
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

import torch

from ..core.constants import DEFAULTS, SAParams
from .common import C_MAX, slots_per_restart
from .engine import search_plain

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sa_search.cu", _PKG / "csrc" / "warmup.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sa_search_launch.argtypes = [
        P, P, P, P, I, I,  # qtypes, qtab, qdmat, n1s, K, n1r
        P, P, P, P, I, I,  # types, tab, dmat, n2, E, d2
        P, P,  # uniforms, keys
        I, I, I, I,  # c_par, r_seq, lorder, lsoln
        I, F, F, F, F, F, I,  # SAParams
        P, P, P]  # out_scores, out_maps, stream
    lib.sa_search_launch.restype = I
    lib.sa_search_prepare.argtypes = [I]  # device_max_smem
    lib.sa_search_prepare.restype = I
    lib.sa_search_smem_bytes.argtypes = [I, I, I, I]
    lib.sa_search_smem_bytes.restype = ctypes.c_size_t
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
            raise RuntimeError("SA kernel prepare failed: "
                               + library.lib.sa_search_error_string(
                                   err).decode())
        library.smem_limit[idx] = limit
    return library.smem_limit[idx]


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


def key_bits(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's key format: the int32 bits of uint32 values held in
    int64 (ops/rng.entry_keys)."""
    return torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(
        torch.int32)


def sa_search(qtypes, qtab, qdmat, n1s, types, tab, dmat, n2, *,
              keys=None, uniforms=None, c_par: int, r_seq: int,
              lorder: bool, lsoln: bool, params: SAParams = DEFAULTS):
    """SA search of K queries against the E entries of one bucket; the
    arguments and results of ops/engine.search_plain.  On the CPU that
    plain version runs; on a CUDA device the kernel is launched (keys:
    in-kernel threefry stream; uniforms: supplied stream)."""
    dev = types.device
    if dev.type == "cpu":
        return search_plain(qtypes, qtab, qdmat, n1s, types, tab, dmat, n2,
                            keys=keys, uniforms=uniforms, c_par=c_par,
                            r_seq=r_seq, lorder=lorder, lsoln=lsoln,
                            params=params)
    if dev.type != "cuda":
        raise ValueError(f"no SA kernel for device {dev}")
    if (keys is None) == (uniforms is None):
        raise ValueError("give exactly one of keys / uniforms")
    if not 1 <= c_par <= C_MAX:
        raise ValueError(f"c_par must be in [1, {C_MAX}], got {c_par}")
    K, n1r = qtypes.shape
    E, d2 = types.shape
    P = slots_per_restart(n1r, params.maxiter)
    check_tensor("qtypes", qtypes, torch.int8, (K, n1r), dev)
    check_tensor("qtab", qtab, torch.uint8, (K, n1r, n1r), dev)
    check_tensor("qdmat", qdmat, torch.float32, (K, n1r, n1r), dev)
    check_tensor("n1s", n1s, torch.int32, (K,), dev)
    check_tensor("types", types, torch.int8, (E, d2), dev)
    check_tensor("tab", tab, torch.uint8, (E, d2, d2), dev)
    check_tensor("dmat", dmat, torch.float32, (E, d2, d2), dev)
    check_tensor("n2", n2, torch.int32, (E,), dev)
    if keys is not None:
        if keys.dtype == torch.int64:
            keys = key_bits(keys)
        check_tensor("keys", keys, torch.int32, (K, E, 2), dev)
    else:
        check_tensor("uniforms", uniforms, torch.float32,
                     (K, E, r_seq, P, c_par), dev)
    scores = torch.empty((K, E), dtype=torch.int32, device=dev)
    maps = (torch.empty((K, E, n1r), dtype=torch.int32, device=dev)
            if lsoln else None)
    if K == 0 or E == 0:
        return scores, maps
    limit = prepare(dev)
    lib = load_library().lib
    smem = lib.sa_search_smem_bytes(n1r, d2, c_par, int(lsoln))
    if smem > limit:
        raise ValueError(f"SA kernel needs {smem} B of shared memory at "
                         f"n1r={n1r}, d2={d2}; the device allows {limit}")
    p = params
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sa_search_launch(
            qtypes.data_ptr(), qtab.data_ptr(), qdmat.data_ptr(),
            n1s.data_ptr(), K, n1r, types.data_ptr(), tab.data_ptr(),
            dmat.data_ptr(), n2.data_ptr(), E, d2,
            uniforms.data_ptr() if uniforms is not None else None,
            keys.data_ptr() if keys is not None else None,
            c_par, r_seq, int(lorder), int(lsoln),
            p.maxiter, p.temp0, p.alpha, p.mxssed, p.init_matchprob, p.eps,
            p.maxscore_init, scores.data_ptr(),
            maps.data_ptr() if maps is not None else None, stream)
    if err != 0:
        raise RuntimeError("SA kernel launch failed: "
                           + lib.sa_search_error_string(err).decode())
    sa_search.launches += 1
    return scores, maps


sa_search.launches = 0
