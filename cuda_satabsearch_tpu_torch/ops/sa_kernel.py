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
current one and joined back by an event, or the call raises.  Where
the launches would fill few waves of the card's CTA slots, each class
splits its chains' restarts over several CTAs (``restart_split``), and
a small reduction kernel after it makes each entry's result; where an
unsplit launch pair fits in one wave, each class runs a chain on
several lanes (``chain_lanes``).  ``sa_search.launches`` counts SA
kernel launches, ``sa_search.split_launches`` those of them that split
and ``sa_search.lane_launches`` those that run a chain on more than one
lane.  With the stream drawn in the kernel, the kernel screens each
move's Metropolis test in float32 (``screens``, ``SCREEN_MARGIN``) and
reads the double-precision log (from a table of the uniform grid made
once per device, ``ln_grid``) only where a warp's move is near the
boundary: ``sa_search.screened_warp_moves`` counts the screened
warp-moves the launches make, a device counter those that took the
exact log, and ``exact_log_share`` reads their ratio (over the launches
the wrapper makes, and not a captured CUDA graph's replays).
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
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from ..core.constants import DEFAULTS, SAParams
from .common import C_MAX, slots_per_restart
from .engine import search_plan_plain
from .rng import M32, check_seed

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sa_search.cu", _PKG / "csrc" / "warmup.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_BUCKETS = 8  # buckets of one launch (csrc/sa_search.cu MAX_BUCKETS)
MAX_K = 65535  # queries of one launch: the grid's y extent
# waves of the card's CTA slots that a restart split fills at least
# (``restart_split``): a launch's tail, about one CTA's time, is then a
# few per cent of it (H100 timings by split and query count: PERF.md)
SPLIT_WAVES = 16
# lanes per chain that the kernel is built for (csrc/sa_search.cu
# ALL_KERNELS; more than 1 only unsplit; 8 timed slower than 4 in every
# class and query width on an H100: PERF.md)
LANES = (1, 2, 4)
# padded query SSEs per lane below which lanes do not pay in a class
# that gives every SM a CTA or more (``chain_lanes``): there the warp
# schedulers are about as busy as one lane's chains need, and a lane's
# share of the delta has to outweigh the move's work that every lane
# repeats (H100 timings by query width and lanes: PERF.md)
LANE_SSES = 12
# the most |fast_ln(u) - ln u| on the uniform grid u = k 2**-23 that the
# Metropolis screen allows for (csrc/sa_search.cu fast_ln: lg2.approx x
# ln 2; tests/test_torch_accept_screen_card.py measures it on the card)
FAST_LN_ERR = 2.0 ** -18
# the screen's margin over the temperature: it bounds |temp * fast_ln(u)
# - temp * ln u| at FAST_LN_ERR with the roundings of the float32 test
# (tests/test_torch_accept_screen.py derives the least such margin and
# holds the screened decision to the exact one on every grid u and
# temperature)
SCREEN_MARGIN = 2.0 ** -17
# the temperatures a screen admits: their float32 products with a log of
# the grid (|ln u| <= 23 ln 2) and with SCREEN_MARGIN stay normal
SCREEN_TEMPS = (2.0 ** -100, 2.0 ** 100)

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


# device index -> int64[1] on it, the count of screened warp-moves that
# took the exact log there (made by ``prepare``; the kernel adds to it)
EXACT_COUNTS: dict = {}
# device index -> float32[2**23] on it, float(log(double(k 2**-23))) for
# every k (``ln_grid``)
LN_GRIDS: dict = {}


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
        F, P, P,  # screen, ln_grid, exact
        I, I, P, P,  # splits, lanes, part, part_maps
        P, P, P]  # out_scores, out_maps, stream
    lib.sa_search_launch.restype = I
    lib.sa_search_prepare.argtypes = [I]  # device_max_smem
    lib.sa_search_prepare.restype = I
    lib.sa_search_smem_bytes.argtypes = [I, I, I, I]
    lib.sa_search_smem_bytes.restype = ctypes.c_size_t
    lib.sa_search_occupancy.argtypes = [I, I, I, I, I, I, P, P, P]
    lib.sa_search_occupancy.restype = I
    lib.sa_search_ln_grid.argtypes = [P, P]  # ln_grid, stream
    lib.sa_search_ln_grid.restype = I
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


def device_index(dev: torch.device) -> int:
    """The index of CUDA device ``dev`` (the current one where it has
    none)."""
    return torch.cuda.current_device() if dev.index is None else dev.index


def prepare(dev: torch.device) -> int:
    """Load the SA kernel's module on CUDA device ``dev``, allow it the
    device's opt-in dynamic shared memory and make its exact-log counter
    and ``ln_grid``, once per device; returns that limit in bytes."""
    library = load_library()
    idx = device_index(dev)
    if idx not in library.smem_limit:
        limit = torch.cuda.get_device_properties(
            idx).shared_memory_per_block_optin
        with torch.cuda.device(idx):
            err = library.lib.sa_search_prepare(limit)
        if err != 0:
            raise cuda_error("SA kernel prepare", err)
        library.smem_limit[idx] = limit
    if idx not in EXACT_COUNTS:
        EXACT_COUNTS[idx] = torch.zeros(1, dtype=torch.int64,
                                        device=torch.device("cuda", idx))
        LN_GRIDS[idx] = ln_grid(idx)
    return library.smem_limit[idx]


def ln_grid(idx: int) -> torch.Tensor:
    """float32[2**23] on CUDA device ``idx``: float(log(double(k
    2**-23))) at k, the kernel's own exact log (ops/rng.ln_f32) of every
    value its draws take; the Metropolis test reads it where the screen
    leaves a move in doubt (32 MiB a device).  Made before it returns, so
    that a launch on any stream may read it; ``ln_grid.launches`` counts
    its kernel's (sa_ln_grid's) launches."""
    grid = torch.empty(2 ** 23, dtype=torch.float32,
                       device=torch.device("cuda", idx))
    stream = torch.cuda.current_stream(idx)
    with torch.cuda.device(idx):
        err = load_library().lib.sa_search_ln_grid(grid.data_ptr(),
                                                   stream.cuda_stream)
    if err != 0:
        raise cuda_error("SA kernel ln_grid", err)
    ln_grid.launches += 1
    stream.synchronize()
    return grid


ln_grid.launches = 0


def temperatures(params: SAParams) -> np.ndarray:
    """The temperature of each of a restart's moves, float32[maxiter]:
    temp0, then times alpha each move, in float32 as the kernel does (a
    running product, one rounding a move)."""
    steps = np.full(params.maxiter, params.alpha, np.float32)
    steps[:1] = params.temp0
    with np.errstate(over="ignore", invalid="ignore"):
        return np.multiply.accumulate(steps)


@functools.lru_cache(maxsize=None)
def screens(params: SAParams) -> bool:
    """Whether the kernel screens the Metropolis test under ``params``:
    where every temperature lies in ``SCREEN_TEMPS`` (so temp0 and alpha
    are positive and finite) and a restart makes moves (once per
    ``params``)."""
    lo, hi = SCREEN_TEMPS
    temps = temperatures(params)
    return bool(temps.size) and bool(((temps >= lo) & (temps <= hi)).all())


def screened_warp_moves(plan, K: int, lanes, *, c_par: int, r_seq: int,
                        maxiter: int) -> int:
    """Warp-moves of the SA launches of K queries against ``plan`` at
    ``lanes`` lanes per chain in each launch class: per (entry, query),
    the warps of c_par x G threads times r_seq x maxiter moves (a split
    runs the same moves in S CTAs of r_seq / S restarts)."""
    return sum(K * cls.entries * -(-c_par * g // 32) * r_seq * maxiter
               for cls, g in zip(plan.classes, lanes))


def exact_log_counts() -> tuple[int, int]:
    """(warp-moves that took the exact log, screened warp-moves) so far,
    over every prepared device and the launches ``sa_search`` made
    outside a CUDA graph's capture; synchronises with the devices, so it
    is never called on the search path."""
    exact = 0
    for idx, count in EXACT_COUNTS.items():
        torch.cuda.synchronize(idx)
        exact += int(count.item())
    return exact, sa_search.screened_warp_moves


def exact_log_share(since: tuple[int, int] = (0, 0)) -> float | None:
    """``sa_search.exact_log_share``: the share of the screened
    warp-moves since ``since`` (an earlier ``exact_log_counts()``) that
    took the exact log; None where none was screened."""
    exact, screened = exact_log_counts()
    if screened == since[1]:
        return None
    return (exact - since[0]) / (screened - since[1])


def occupancy(d2max: int, n1r: int, c_par: int, lsoln: bool,
              split: bool = False, lanes: int = 1) -> tuple[int, int, int]:
    """(CTAs per SM, registers per thread, local bytes per thread) of the
    kernel instantiation that runs a launch class whose widest bucket is
    ``d2max``, unsplit at ``lanes`` lanes per chain (c_par x lanes
    threads) or (``split``) split (on the current device, after
    ``prepare``)."""
    out = [ctypes.c_int() for _ in range(3)]
    err = load_library().lib.sa_search_occupancy(
        d2max, n1r, c_par, int(lsoln), int(split), lanes,
        *(ctypes.byref(o) for o in out))
    if err != 0:
        raise cuda_error("SA kernel occupancy query", err)
    return tuple(o.value for o in out)


def class_slots(plan, cls, n1r: int, c_par: int, lsoln: bool,
                lanes: int = 1) -> int:
    """CTAs of one launch of ``cls`` (a launch class of ``plan``,
    ops/kernel_search.make_plan) that the card holds at once: its SMs
    times the CTAs of the class's unsplit kernel at ``lanes`` lanes per
    chain resident on one SM (``occupancy``), taken once per class and
    (n1r, c_par, lsoln, lanes); 0 off a card."""
    key = (n1r, c_par, lsoln, lanes)
    if key not in cls.slots:
        slots = 0
        if plan.sms:
            with device_guard(plan.device):
                slots = plan.sms * occupancy(cls.d2max, n1r, c_par, lsoln,
                                             lanes=lanes)[0]
        cls.slots[key] = slots
    return cls.slots[key]


def restart_split(plan, K: int, n1r: int, *, c_par: int, r_seq: int,
                  lsoln: bool) -> int:
    """The restart split S of K queries padded to n1r against ``plan``:
    each launch class runs every (entry, query) as S CTAs of r_seq / S
    restarts.  The least power of two that divides r_seq at which the
    launches fill at least ``SPLIT_WAVES`` waves of the card (the
    classes' K * entries * S / ``class_slots`` summed), or the largest
    one short of that.  1 where r_seq is odd (before any occupancy
    query) or off a card."""
    if r_seq % 2 or not plan.sms:
        return 1
    slots = [class_slots(plan, cls, n1r, c_par, lsoln)
             for cls in plan.classes]
    if not all(slots):
        return 1
    waves = sum(Fraction(K * cls.entries, m)
                for cls, m in zip(plan.classes, slots))
    split = 1
    while r_seq % (2 * split) == 0 and waves * split < SPLIT_WAVES:
        split *= 2
    return split


def chain_lanes(plan, K: int, n1r: int, *, c_par: int, lsoln: bool,
                split: int) -> tuple[int, ...]:
    """Lanes per chain G of each launch class of ``plan`` (in its order)
    for K queries padded to n1r whose launches split ``split`` ways
    (``restart_split``): where they do not split, the narrow class's G
    and then the wide class's, each the largest of ``LANES`` at which
    the classes' K * entries / ``class_slots``(G) summed stays within
    one wave of the card, the other class at the G chosen so far (1
    before it is chosen), and at which the class's K * entries * G stays
    within the card's SMs or each lane keeps ``LANE_SSES`` of the n1r.
    All 1 where the launches split, off a card (both before any
    occupancy query) and where they fill more than one wave at one
    lane."""
    lanes = [1] * len(plan.classes)

    def fits() -> bool:
        slots = [class_slots(plan, cls, n1r, c_par, lsoln, g)
                 for cls, g in zip(plan.classes, lanes)]
        return all(slots) and sum(
            Fraction(K * cls.entries, m)
            for cls, m in zip(plan.classes, slots)) <= 1

    if split > 1 or not plan.sms or not fits():
        return tuple(lanes)
    for i in sorted(range(len(lanes)), key=lambda i: plan.classes[i].d2max):
        ctas = K * plan.classes[i].entries
        for g in LANES[::-1]:
            lanes[i] = g
            if g == 1 or ((ctas * g <= plan.sms or LANE_SSES * g <= n1r)
                          and fits()):
                break
    return tuple(lanes)


def launch_shape(plan, K: int, n1r: int, *, c_par: int, r_seq: int,
                 lsoln: bool) -> tuple[int, tuple[int, ...]]:
    """(S, lanes per chain of each launch class) of the SA launches of K
    queries padded to n1r against ``plan``: ``restart_split``'s S and
    ``chain_lanes``' lanes at that S."""
    split = restart_split(plan, K, n1r, c_par=c_par, r_seq=r_seq,
                          lsoln=lsoln)
    return split, chain_lanes(plan, K, n1r, c_par=c_par, lsoln=lsoln,
                              split=split)


@functools.lru_cache(maxsize=None)
def launch_streams(index: int):
    """(side stream, fork event, join event) of CUDA device ``index``:
    a plan's wide class runs on the side stream, forked from and joined
    back to the current stream."""
    with torch.cuda.device(index):
        return torch.cuda.Stream(), torch.cuda.Event(), torch.cuda.Event()


def fork_join(current, wide, narrow) -> None:
    """Run ``wide(side)`` on the side stream of ``current``'s device
    (``launch_streams``), forked from ``current``, then ``narrow(current)``,
    and join the side stream back to ``current``: how a plan's two launch
    classes run together."""
    side, fork, join = launch_streams(current.device_index)
    fork.record(current)
    side.wait_event(fork)
    wide(side)
    narrow(current)
    join.record(side)
    current.wait_event(join)


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


def descriptor(members) -> PlanDesc:
    """The kernel's descriptor of a launch class's [(bucket, first output
    column)], made once with its plan (ops/kernel_search.make_plan; the
    buckets' tensors stay resident)."""
    desc = PlanDesc(nb=len(members))
    first = 0
    for i, (b, out) in enumerate(members):
        E = len(b.index)
        desc.b[i] = BucketDesc(
            b.types.data_ptr(), b.tab.data_ptr(), b.dmat.data_ptr(),
            b.n2.data_ptr(), b.index_dev.data_ptr(), b.dim, E, first, out)
        first += E
    return desc


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
    class (at most two) is made, split as ``restart_split`` says (a
    split launch is followed by its reduction kernel) and at the lanes
    per chain ``chain_lanes`` gives (the results are bitwise those of the
    unsplit launch at one lane per chain).  Returns (scores int32[K, E],
    maps int32[K, E, n1r] or None), E = plan.nentries in the plan's
    order.  ``seed`` must lie in [-2**31, 2**31) (ops/rng.check_seed).
    Drawn in the kernel, each move's acceptance is screened where
    ``screens(params)``; the results are bitwise the same."""
    seed = check_seed(seed)
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
    if K > MAX_K:
        raise ValueError(f"{K} queries in one launch; the grid takes "
                         f"{MAX_K} (ops/kernel_search tiles a group)")
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
            p.alpha, p.mxssed, p.init_matchprob, p.eps, p.maxscore_init)
    # the screen's margin and the exact logs, or a NaN margin: no screen
    # (every move reads the exact log)
    idx = device_index(dev)
    screen = uniforms is None and screens(params)
    args += (SCREEN_MARGIN if screen else float("nan"),
             LN_GRIDS[idx].data_ptr())
    outs = (scores.data_ptr(), maps.data_ptr() if maps is not None else None)
    split, lanes = launch_shape(plan, K, n1r, c_par=c_par, r_seq=r_seq,
                                lsoln=lsoln)
    # a split launch's scratch (per split, its best score and winner,
    # and under LSOLN the winner's map), made on the current stream,
    # which waits for both classes before anything can reuse it
    scratch = [(torch.empty(2 * K * cls.entries * split, dtype=torch.int32,
                            device=dev),
                torch.empty(K * cls.entries * split * n1r, dtype=torch.int8,
                            device=dev) if lsoln else None)
               if split > 1 else (None, None) for cls in plan.classes]

    def launch(i, stream):
        cls, (part, part_maps) = plan.classes[i], scratch[i]
        err = lib.sa_search_launch(
            ctypes.byref(cls.desc), cls.d2max, *args, exact, split, lanes[i],
            None if part is None else part.data_ptr(),
            None if part_maps is None else part_maps.data_ptr(), *outs,
            stream.cuda_stream)
        if err != 0:
            raise cuda_error("SA kernel launch", err)
        sa_search.launches += 1
        sa_search.split_launches += split > 1
        sa_search.lane_launches += lanes[i] > 1

    with device_guard(dev):
        # the exact-log counter and the screened warp-moves count the
        # launches run now, not those a CUDA graph captures (whose
        # replays would add to the one and not the other)
        count = screen and not torch.cuda.is_current_stream_capturing()
        exact = EXACT_COUNTS[idx].data_ptr() if count else None
        current = torch.cuda.current_stream(dev)
        if len(plan.classes) == 1:
            launch(0, current)
        else:  # the wide class on the side stream: both classes together
            fork_join(current, functools.partial(launch, 0),
                      functools.partial(launch, 1))
    if count:
        sa_search.screened_warp_moves += screened_warp_moves(
            plan, K, lanes, c_par=c_par, r_seq=r_seq, maxiter=p.maxiter)
    return scores, maps


sa_search.launches = 0
sa_search.split_launches = 0
sa_search.lane_launches = 0
sa_search.screened_warp_moves = 0
