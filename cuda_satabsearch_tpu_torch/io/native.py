"""Native C++ DB loader: parse + pack, score statistics, ASCII emission.

Counterpart of cuda_satabsearch_tpu/io/native.py.  The library is built
from the repository's ``native/satab_io.cpp`` (read, never written) with
the host C++ compiler and the flags of ``native/Makefile`` into
``cuda_satabsearch_tpu_torch/_build/satab_io_<hash>.so``, keyed by a
hash of the source, the compiler and the flags, at first use and with
an atomic rename (the scheme of ops/sa_kernel.load_library).  Nothing is
written under ``native/`` and the committed ``native/libsatab_io.so`` is
never loaded.  A failed build raises with the compiler's output.

``unavailable()`` says why the loader cannot be used here (``SATAB_NATIVE=0``,
no source, no compiler), or None; the session then parses in Python.
Where the native parser rejects a file, the file is parsed again in
Python, so the result or the error is the Python parser's own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..core.codes import TYPE_PAD
from ..core.constants import MAXDIM
from .pack import (DEFAULT_BUCKETS, DMAT_PAD, PackedBucket, PackedDB,
                   pack_database, quantize_dmat)
from .parser import read_database

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "satab_io.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")  # native/Makefile's


def find_cxx() -> str | None:
    """The host C++ compiler, the one nvcc itself uses."""
    return shutil.which("g++")


def unavailable() -> str | None:
    """Why the native loader cannot be used here, or None."""
    if os.environ.get("SATAB_NATIVE", "1") == "0":
        return "SATAB_NATIVE=0"
    if not SOURCE.is_file():
        return f"{SOURCE} not found"
    if find_cxx() is None:
        return "no C++ compiler (g++) found"
    return None


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Build ``source`` into ``build_dir`` once per (source, compiler,
    flags) hash; returns the library's path.  Raises RuntimeError with the
    compiler's output if the build fails."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    digest = hashlib.sha256(source.read_bytes() + cxx.encode()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = build_dir / f"satab_io_{digest}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({res.returncode}) on "
                               f"{source}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per hash) and load the library, prototypes bound."""
    lib = ctypes.CDLL(str(build()))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    pi8, pi32 = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32)
    pf32, pf64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    protos = {
        "satab_pack_file": (P, [ctypes.c_char_p, I, ctypes.POINTER(I), I]),
        "satab_error": (ctypes.c_char_p, [P]),
        "satab_nentries": (I64, [P]),
        "satab_bucket_count": (I64, [P, I]),
        "satab_bucket_cap": (I, [P, I]),
        "satab_bucket_tabhi": (pi8, [P, I]),
        "satab_bucket_tablo": (pi8, [P, I]),
        "satab_bucket_types": (pi8, [P, I]),
        "satab_bucket_dmat": (pf32, [P, I]),
        "satab_bucket_orders": (pi32, [P, I]),
        "satab_bucket_index": (pi32, [P, I]),
        "satab_bucket_names": (ctypes.POINTER(ctypes.c_char), [P, I]),
        "satab_label_size": (I, []),
        "satab_free": (None, [P]),
        "satab_score_stats": (None, [pi32, pi32, I64, I, ctypes.c_double,
                                     ctypes.c_double, I, pf64, pf64, pf64]),
        "satab_format_entry": (P, [ctypes.c_char_p, I, pi8, pi8, pi8, pf32]),
        "satab_free_text": (None, [P]),
    }
    for name, (restype, argtypes) in protos.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _as_array(ptr, shape, dtype):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array(ptr, shape=(n,)).view(dtype).reshape(
        shape).copy()


def _pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
    extra = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, extra])


def pack_database_file(path: str, buckets: tuple = DEFAULT_BUCKETS,
                       maxdim: int = MAXDIM, pad_to: int = 1) -> PackedDB:
    """Parse + pack an ASCII DB file natively into a PackedDB, bitwise
    equal to io/pack.pack_database(io/parser.read_database(path)).  A
    file the native parser rejects (or cannot open) is parsed again in
    Python, whose result or error is returned or raised."""
    lib = load_library()
    caps = (ctypes.c_int * len(buckets))(*buckets)
    h = lib.satab_pack_file(os.fsencode(path), maxdim, caps, len(buckets))
    if not h or lib.satab_error(h):
        if h:
            lib.satab_free(h)
        return pack_database(read_database(path, maxdim=maxdim), buckets,
                             pad_to=pad_to)
    try:
        nentries = lib.satab_nentries(h)
        label = lib.satab_label_size() + 1
        packed = []
        names_all: list = [None] * nentries
        orders_all = np.zeros((nentries,), np.int32)
        for b in range(len(buckets)):
            cnt = lib.satab_bucket_count(h, b)
            if cnt == 0:
                continue
            cap = lib.satab_bucket_cap(h, b)
            tabhi = _as_array(lib.satab_bucket_tabhi(h, b), (cnt, cap, cap),
                              np.int8)
            tablo = _as_array(lib.satab_bucket_tablo(h, b), (cnt, cap, cap),
                              np.int8)
            types = _as_array(lib.satab_bucket_types(h, b), (cnt, cap),
                              np.int8)
            dmat = quantize_dmat(_as_array(lib.satab_bucket_dmat(h, b),
                                           (cnt, cap, cap), np.float32))
            orders = _as_array(lib.satab_bucket_orders(h, b), (cnt,),
                               np.int32)
            index = _as_array(lib.satab_bucket_index(h, b), (cnt,), np.int32)
            raw = ctypes.string_at(lib.satab_bucket_names(h, b), cnt * label)
            names = [raw[i * label:(i + 1) * label].split(b"\0")[0].decode()
                     for i in range(cnt)]
            for i in range(cnt):
                names_all[index[i]] = names[i]
                orders_all[index[i]] = orders[i]
            n = -(-cnt // pad_to) * pad_to
            if n > cnt:  # the padding rows of io/pack.pack_database
                tabhi = _pad_rows(tabhi, n, 0)
                tablo = _pad_rows(tablo, n, 0)
                types = _pad_rows(types, n, TYPE_PAD)
                dmat = _pad_rows(dmat, n, quantize_dmat(
                    np.float32(DMAT_PAD)).item())
                orders = _pad_rows(orders, n, 1)
                index = _pad_rows(index, n, -1)
                names = names + ["<pad>"] * (n - cnt)
            packed.append(PackedBucket(dim=cap, tabhi=tabhi, tablo=tablo,
                                       types=types, dmat=dmat, orders=orders,
                                       names=names, index=index))
        return PackedDB(buckets=packed, nentries=int(nentries),
                        names=names_all, orders=orders_all)
    finally:
        lib.satab_free(h)


def score_stats_native(scores, orders, qn: int, a: float, b: float,
                       compat: bool = False):
    """Batch (norm2, z, p) via the C++ twin of gumbelstats.c."""
    lib = load_library()
    scores = np.ascontiguousarray(scores, np.int32)
    orders = np.ascontiguousarray(orders, np.int32)
    n = len(scores)
    n2, z, p = (np.empty(n, np.float64) for _ in range(3))
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pf64 = ctypes.POINTER(ctypes.c_double)
    lib.satab_score_stats(scores.ctypes.data_as(pi32),
                          orders.ctypes.data_as(pi32), n, qn, a, b,
                          int(compat), n2.ctypes.data_as(pf64),
                          z.ctypes.data_as(pf64), p.ctypes.data_as(pf64))
    return n2, z, p


def format_entry_native(entry) -> str:
    """ASCII emission via the C++ twin of io/writer.format_entry,
    byte-identical to it."""
    lib = load_library()
    n = entry.order
    tabhi = np.ascontiguousarray(entry.tabhi[:n, :n], np.int8)
    tablo = np.ascontiguousarray(entry.tablo[:n, :n], np.int8)
    types = np.ascontiguousarray(entry.types[:n], np.int8)
    dmat = np.ascontiguousarray(entry.dmat[:n, :n], np.float32)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    ptr = lib.satab_format_entry(
        entry.name.encode(), n, tabhi.ctypes.data_as(pi8),
        tablo.ctypes.data_as(pi8), types.ctypes.data_as(pi8),
        dmat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if not ptr:
        raise ValueError(f"{entry.name}: unencodable entry")
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.satab_free_text(ptr)
