"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernel library (the SA search kernel and the start-up
kernel) from cuda_satabsearch_tpu_torch/csrc/ with nvcc, one process per
source, while the native DB loader (native/satab_io.cpp) builds with
g++; holds each kernel against its plain PyTorch version on the card,
drives the port's main paths (the ``torchsatabsearch`` CLI, the
acceptance gate, the sharded search) on the 586-entry fixture DB, and
times a 14291-entry ASTRAL-like synthetic DB.  Phases:

0. start-up kernel vs x + 1 on f32[8, 128] and on an odd size: bitwise,
   both timed per call (CUDA events over a loop) and device-only
   (torch.profiler);
1. SA kernel vs plain engine on a supplied stream: bitwise scores and
   maps, including c_par 128 x r_seq 32 (the r = 4096 split);
2. kernel's in-kernel threefry stream vs the plain engine on the stream
   ops/rng.py makes on the card: bitwise, the same cases;
3. CLI main path, d1ubia_ query vs the 586-entry DB at r=128: the
   reference's top 3, scores equal to the plain engine's on the card,
   and both kernels' launch counters show the path ran through them;
4. multiquery.input (8/13/101-SSE queries): batched search_many equals
   per-query search, bitwise;
5. timings: kernel vs plain on the 586-entry DB, and the 14291-entry
   synthetic DB per query and batched;
6. native DB loader vs Python parse + pack, bitwise, on the 586-entry
   fixture and on the synthetic DB written by io/writer.py, both timed;
7. acceptance gate: d1ubia_, d1ae6h1 and d2phlb1 at r = 128 and
   r = 4096 on the kernel against the reference CPU oracle's outputs
   (tests/fixtures/refgolden/), ranked by norm2; d2phlb1 at r = 4096
   must reach auc5 >= 0.9815;
8. sharded vs unsharded search, bitwise on scores and maps, on the mesh
   [cuda:0, cuda:0] and on all visible devices, on both DBs, timed;
9. the first and second search of fresh processes running the CLI on
   d1ubia_.input, with the full start-up and with the start-up kernel
   alone;
10. the evaluation path on the card: the three evaluation drivers of
   cuda_satabsearch_tpu_torch/eval/ into a temporary directory.
   ``make_eval_artifact`` runs multiquery.input through the CLI in a
   subprocess (the kernel row must reach a mean AUC within 0.01 of the
   JAX package's 0.9796 and print, header aside, the JAX package's
   committed XLA-engine output byte for byte), ``gumbel_fit_artifact``
   fits 24 queries at r = 4096 (24 finite rows), ``acceptance_eval``
   writes its report (verdict PASS); the SA kernel's launch counter must
   move in each.

Prints one line per phase, then a JSON line with the kernels' numbers,
then ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
without that line when there is no CUDA device or any phase fails.
"""

import concurrent.futures
import contextlib
import functools
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TOP3 = {"d1c3ta_", "d2faza1", "d1uela_"}  # README_example_usage.txt:92-111
DB586 = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
# the JAX package's committed mean AUC of its multiquery run
# (eval_artifacts/auc_table.txt); the card's kernel row must come within
# 0.01 of it
JAX_MEAN_AUC = 0.9796
JAX_XLA_OUT = os.path.join(ROOT, "eval_artifacts",
                           "multiquery_tpu-xla-engine.out")
# the program-name header of a search output
HEADER = re.compile(r"^# \S+ LTYPE = .*\n", re.M)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else (
        f"nvidia-smi failed: {res.stderr.strip()}")


def random_entry(rng, n, name):
    """A random valid entry (symmetric tableau, consistent diagonals)."""
    from cuda_satabsearch_tpu_torch.io.parser import TableauEntry

    types = rng.integers(0, 4, size=n).astype(np.uint8)
    hi = np.triu(rng.integers(0, 4, size=(n, n)), 1).astype(np.uint8)
    lo = np.triu(rng.integers(0, 4, size=(n, n)), 1).astype(np.uint8)
    hi, lo = hi + hi.T, lo + lo.T
    np.fill_diagonal(hi, types)
    np.fill_diagonal(lo, types)
    d = np.triu(rng.random((n, n)) * 25.0, 1).astype(np.float32)
    d = (d + d.T).astype(np.float32)
    np.fill_diagonal(d, types.astype(np.float32))
    return TableauEntry(name=name, order=n, tabhi=hi, tablo=lo, types=types,
                        dmat=d)


@functools.lru_cache(maxsize=None)
def synthetic_entries(n):
    """ASTRAL-2.07-like SSE-count mix (median ~10, tail to 111); the
    generator of bench.py, which imports the JAX package."""
    from cuda_satabsearch_tpu_torch.io.parser import TableauEntry

    rng = np.random.default_rng(0)
    orders = np.clip(rng.lognormal(2.35, 0.55, size=n).astype(int), 2, 111)
    out = []
    for i, o in enumerate(sorted(orders)):
        types = rng.integers(0, 4, size=o).astype(np.uint8)
        hi = np.triu(rng.integers(0, 4, size=(o, o)), 1).astype(np.uint8)
        hi = hi + hi.T
        lo = np.triu(rng.integers(0, 4, size=(o, o)), 1).astype(np.uint8)
        lo = lo + lo.T
        np.fill_diagonal(hi, types)
        np.fill_diagonal(lo, types)
        d = np.triu(rng.random((o, o)) * 30.0, 1).astype(np.float32)
        d = (d + d.T).astype(np.float32)
        np.fill_diagonal(d, types.astype(np.float32))
        out.append(TableauEntry(name=f"syn{i:05d}", order=int(o), tabhi=hi,
                                tablo=lo, types=types, dmat=d))
    return out


def read_query(name):
    from cuda_satabsearch_tpu_torch.io.pack import pack_query
    from cuda_satabsearch_tpu_torch.io.parser import parse_search_input

    with open(os.path.join(FIXTURES, name)) as fp:
        return [pack_query(q) for q in parse_search_input(fp).queries]


def kernel_cases(dev):
    """Random (queries, bucket) problems at the main path's shapes:
    bucket widths d2 x query orders n1, each with two of the 32
    combinations of LORDER, LSOLN, c_par, r_seq and K (all 32 used),
    then four cases at c_par 128 x r_seq 32 (the acceptance gate's
    r = 4096) with 3 entries."""
    from cuda_satabsearch_tpu_torch.io.pack import pack_database, pack_query
    from cuda_satabsearch_tpu_torch.ops.common import round8
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (
        pack_queries, prepare_bucket)

    rng = np.random.default_rng(2024)
    combos = list(itertools.product((True, False), (True, False), (128, 100),
                                    (1, 2), (1, 3)))
    shapes = list(itertools.product((8, 16, 48, 112), (5, 8, 13, 19, 101)))
    pairs = list(zip(shapes * 2, combos + combos[:8]))
    # c_par 128 x r_seq 32, the split of r = 4096, at small E
    pairs += [((16, 19), (True, False, 128, 32, 1)),
              ((24, 19), (False, True, 128, 32, 3)),
              ((112, 19), (True, True, 128, 32, 1)),
              ((32, 13), (True, False, 128, 32, 3))]
    for ci, ((d2, n1), combo) in enumerate(pairs):
        lorder, lsoln, c_par, r_seq, K = combo
        n1r = round8(n1)
        orders = [n1, max(n1r - 7, 2), n1r][:K]
        queries = [pack_query(random_entry(rng, o, f"q{k}"))
                   for k, o in enumerate(orders)]
        lo = max(2, d2 - 7) if d2 > 8 else 2
        E = 5 if r_seq < 32 else 3
        entries = [random_entry(rng, int(o), f"e{i}")
                   for i, o in enumerate(rng.integers(lo, d2 + 1, size=E))]
        bucket = prepare_bucket(
            pack_database(entries, buckets=(d2, 112) if d2 < 112 else (112,)
                          ).buckets[0], dev)
        q = pack_queries(queries, n1r, dev)
        yield ci, dict(lorder=lorder, lsoln=lsoln, c_par=c_par, r_seq=r_seq,
                       K=K, d2=d2, n1=n1), q, bucket


def compare(a, b):
    """Largest |difference| of two (scores, maps) results."""
    err = (a[0].long() - b[0].long()).abs().max().item()
    if a[1] is not None or b[1] is not None:
        err = max(err, (a[1].long() - b[1].long()).abs().max().item())
    return err


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls (CUDA events), after
    one untimed call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean device ms per call of the kernels ``fn()`` launches
    (torch.profiler's CUDA kernel records) and their count; (None, 0)
    where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, 0
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / 1e3 / reps, len(kernels)


def phase0(dev, out):
    from cuda_satabsearch_tpu_torch.core.warmup import SHAPE, add_one

    rng = np.random.default_rng(3)
    err = 0.0
    for shape in (SHAPE, (3, 37), (1027,)):  # odd sizes: the scalar tail
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        got = add_one(x)
        torch.cuda.synchronize()
        err = max(err, (got - (x + 1.0)).abs().max().item())
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).to(
        dev)
    # plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: x + 1.0, 200)
    k1 = cuda_ms(lambda: add_one(x), 200)
    k2 = cuda_ms(lambda: add_one(x), 200)
    p2 = cuda_ms(lambda: x + 1.0, 200)
    out["warm_ms"], out["warm_plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"phase0 start-up kernel == x + 1 on f32{list(SHAPE)}, f32[3, 37] "
        f"and f32[1027] on the card: max |diff| {err} (tolerance 0: "
        f"bitwise); per call in a 200-call loop: kernel {k1:.5f} / "
        f"{k2:.5f} ms, plain {p1:.5f} / {p2:.5f} ms (CUDA events)")
    pd1, pn = device_ms(lambda: x + 1.0, 200)
    kd1, kn = device_ms(lambda: add_one(x), 200)
    kd2, _ = device_ms(lambda: add_one(x), 200)
    pd2, _ = device_ms(lambda: x + 1.0, 200)
    fmt = lambda v: "not measured" if v is None else f"{v:.5f}"
    say(f"phase0 device-only per call (torch.profiler, 200 calls): kernel "
        f"{fmt(kd1)} / {fmt(kd2)} ms ({kn} kernel records), plain "
        f"{fmt(pd1)} / {fmt(pd2)} ms ({pn} kernel records)")
    if err:
        raise AssertionError(f"start-up kernel differs from x + 1 by {err}")
    return err


def phase1(dev, out):
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.common import slots_per_restart
    from cuda_satabsearch_tpu_torch.ops.engine import search_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    urng = np.random.default_rng(7)
    worst, n = 0, 0
    for ci, cfg, q, b in kernel_cases(dev):
        n1r = q[0].shape[1]
        P = slots_per_restart(n1r)
        E = b.types.shape[0]
        shape = (cfg["K"], E, cfg["r_seq"], P, cfg["c_par"])
        u = torch.from_numpy(urng.random(shape, dtype=np.float32)).to(dev)
        u = rng.log_acc_slots(u, n1r).contiguous()
        kw = dict(c_par=cfg["c_par"], r_seq=cfg["r_seq"],
                  lorder=cfg["lorder"], lsoln=cfg["lsoln"])
        got = sa_search(*q, b.types, b.tab, b.dmat, b.n2, uniforms=u, **kw)
        torch.cuda.synchronize()
        ref = search_plain(*q, b.types, b.tab, b.dmat, b.n2, uniforms=u, **kw)
        err = compare(got, ref)
        if err:
            raise AssertionError(f"phase1 case {ci} {cfg}: max |diff| {err}")
        worst, n = max(worst, err), n + 1
    say(f"phase1 supplied stream, kernel == plain on the card: {n} cases, "
        f"max |diff| {worst} (tolerance 0: bitwise)")
    return worst


def phase2(dev, out):
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.engine import search_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    worst, n = 0, 0
    for ci, cfg, q, b in kernel_cases(dev):
        E = b.types.shape[0]
        keys = rng.entry_keys(1234, list(range(ci, ci + cfg["K"])),
                              np.arange(E), device=dev)
        kw = dict(c_par=cfg["c_par"], r_seq=cfg["r_seq"],
                  lorder=cfg["lorder"], lsoln=cfg["lsoln"])
        got = sa_search(*q, b.types, b.tab, b.dmat, b.n2, keys=keys, **kw)
        torch.cuda.synchronize()
        ref = search_plain(*q, b.types, b.tab, b.dmat, b.n2, keys=keys, **kw)
        err = compare(got, ref)
        if err:
            raise AssertionError(f"phase2 case {ci} {cfg}: max |diff| {err}")
        worst, n = max(worst, err), n + 1
    say(f"phase2 in-kernel threefry == plain on ops/rng.py's stream "
        f"(ln_f32 on the card): {n} cases, max |diff| {worst} "
        f"(tolerance 0: bitwise)")
    # ln u on the card vs on the CPU over every non-zero uniform
    # (k * 2**-23): where they differ, -c and the card may part ways
    grid = torch.arange(1, 2 ** 23, dtype=torch.float64).mul_(
        2.0 ** -23).float()
    diff = int((rng.ln_f32(grid.to(dev)).cpu() != rng.ln_f32(grid)).sum())
    say(f"phase2 ln_f32 card vs CPU over {grid.numel()} uniform grid "
        f"values: {diff} differ")
    return worst


def phase3(dev, out):
    from cuda_satabsearch_tpu_torch import cli
    from cuda_satabsearch_tpu_torch.core.warmup import add_one
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        body = fp.read().splitlines(keepends=True)[2:]
    stdin = io.StringIO(f"{DB586}\nT T F\n" + "".join(body))
    stdout, stderr = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    sa_search.launches = add_one.launches = 0
    t0 = time.perf_counter()
    try:
        sys.stdin = stdin
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = cli.main(["-r", "128"])
    finally:
        sys.stdin = old_stdin
    wall = time.perf_counter() - t0
    launches, warm_launches = sa_search.launches, add_one.launches
    out["launches"], out["warm_launches"] = launches, warm_launches
    if rc != 0:
        raise AssertionError(f"CLI exit {rc}: {stderr.getvalue()}")
    rows = [ln.split() for ln in stdout.getvalue().splitlines()
            if not ln.startswith("#")]
    names = [r[0] for r in rows]
    scores = np.array([int(r[1]) for r in rows])
    ranked = sorted(zip(-scores, range(len(names))))[:3]
    top3 = [(names[i], int(-s)) for s, i in ranked]
    say(f"phase3 CLI -r 128, d1ubia_ vs {len(names)} entries: top 3 {top3}, "
        f"{launches} SA kernel launches, {warm_launches} start-up kernel "
        f"launches, {wall:.3f} s wall (incl. parse)")
    if len(names) != 586 or {n for n, _ in top3} != TOP3:
        raise AssertionError(f"top 3 {top3} != {sorted(TOP3)}")
    if launches < 1:
        raise AssertionError("the CLI never launched the SA kernel")
    if warm_launches < 1:
        raise AssertionError("the CLI never launched the start-up kernel")
    plain = SearchSession(DB586, SessionConfig(maxstart=128, backend="torch",
                                                device=str(dev)))
    query = read_query("d1ubia_.input")[0]
    ref = plain.search(query, lorder=True, lsoln=False, query_tag=0)
    diff = int(np.abs(ref.scores - scores).max())
    say(f"phase3 CLI scores vs the plain engine on the card: max |diff| "
        f"{diff} (tolerance 0)")
    if diff:
        raise AssertionError("kernel and plain scores differ on the CLI path")
    return diff


def phase4(dev, out):
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    queries = read_query("multiquery.input")
    sess = SearchSession(DB586, SessionConfig(maxstart=128, backend="cuda",
                                               device=str(dev)))
    batched = sess.search_many(queries, lorder=True, lsoln=True)
    worst = 0
    for tag, (q, b) in enumerate(zip(queries, batched)):
        s = sess.search(q, lorder=True, lsoln=True, query_tag=tag)
        worst = max(worst, int(np.abs(s.scores - b.scores).max()),
                    int(np.abs(s.ssemaps - b.ssemaps).max()))
    say(f"phase4 multiquery.input ({[q.order for q in queries]} SSEs), "
        f"batched search_many == per-query search: max |diff| {worst} "
        f"(tolerance 0)")
    if worst:
        raise AssertionError("batched and per-query results differ")
    return worst


def time_buckets(fn, sess, query, reps):
    """Mean ms of one query's launches over every bucket (CUDA events)."""
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.common import round8
    from cuda_satabsearch_tpu_torch.ops.kernel_search import pack_queries

    dev = sess.device
    q = pack_queries([query], round8(query.order), dev)
    (buckets,) = sess.device_db  # one shard: the whole DB
    keys = [rng.entry_keys(1234, [0], b.index, device=dev) for b in buckets]
    kw = dict(c_par=128, r_seq=1, lorder=True, lsoln=False)

    def run():
        for b, k in zip(buckets, keys):
            fn(*q, b.types, b.tab, b.dmat, b.n2, keys=k, **kw)

    return cuda_ms(run, reps)


def phase5(dev, out, card):
    from cuda_satabsearch_tpu_torch.ops.engine import search_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    query = read_query("d1ubia_.input")[0]
    sess = SearchSession(DB586, SessionConfig(maxstart=128, device=str(dev)))
    # plain, kernel, kernel, plain
    p1 = time_buckets(search_plain, sess, query, 2)
    k1 = time_buckets(sa_search, sess, query, 20)
    k2 = time_buckets(sa_search, sess, query, 20)
    p2 = time_buckets(search_plain, sess, query, 2)
    out["ms"], out["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    it586 = sess.nentries * 128 * 100
    say(f"phase5 586 entries, 8-SSE query, r=128, one query over all "
        f"buckets: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
        f"{p2:.4f} ms (CUDA events); kernel {it586 / (k1 + k2) * 2e-3:.1f} "
        f"M it/s; card {card}")

    t0 = time.perf_counter()
    big = SearchSession("<synthetic>", SessionConfig(maxstart=128,
                                                     device=str(dev)),
                        entries=synthetic_entries(14291))
    say(f"phase5 synthetic DB: {big.nentries} entries built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    big.search(query, lsoln=False)  # warm-up
    walls = []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = big.search(query, lsoln=False, query_tag=rep)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    it = big.nentries * 128 * 100
    best = min(walls)
    if not np.all(res.scores >= 0):
        raise AssertionError("negative max score on the synthetic DB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.search_many([query] * 8, lsoln=False)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    out["large_ms"] = best * 1e3
    say(f"phase5 14291 entries, 8-SSE query, r=128: per query "
        f"{[round(w * 1e3, 3) for w in walls]} ms wall, best "
        f"{it / best / 1e6:.1f} M it/s; 8 queries batched {wall8 * 1e3:.3f} "
        f"ms, {8 * it / wall8 / 1e6:.1f} M it/s; card {card}")


def packed_diff(a, b) -> list[str]:
    """The fields in which two PackedDBs differ (bitwise)."""
    bad = [f for f in ("nentries", "names") if getattr(a, f) != getattr(b, f)]
    if not np.array_equal(a.orders, b.orders):
        bad.append("orders")
    if len(a.buckets) != len(b.buckets):
        return bad + ["buckets"]
    for i, (x, y) in enumerate(zip(a.buckets, b.buckets)):
        if x.dim != y.dim or x.names != y.names:
            bad.append(f"bucket {i} dim/names")
        for f in ("tabhi", "tablo", "types", "dmat", "orders", "index"):
            u, v = getattr(x, f), getattr(y, f)
            if u.dtype != v.dtype or not np.array_equal(u.view(np.uint8),
                                                        v.view(np.uint8)):
                bad.append(f"bucket {i} {f}")
    return bad


def phase6(dev, out):
    from cuda_satabsearch_tpu_torch.io import native
    from cuda_satabsearch_tpu_torch.io.pack import pack_database
    from cuda_satabsearch_tpu_torch.io.parser import read_database
    from cuda_satabsearch_tpu_torch.io.writer import format_database

    native.load_library()  # built in main(); loading is not parsing
    with tempfile.TemporaryDirectory() as tmp:
        syn = os.path.join(tmp, "synthetic14291.ascii")
        t0 = time.perf_counter()
        with open(syn, "w") as fp:
            fp.write(format_database(synthetic_entries(14291)))
        say(f"phase6 synthetic DB written by io/writer.py in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(syn) / 2 ** 20:.1f} MiB)")
        for name, path in (("586-entry fixture", DB586),
                           ("14291-entry synthetic", syn)):
            t0 = time.perf_counter()
            ndb = native.pack_database_file(path)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            pdb = pack_database(read_database(path))
            t_python = time.perf_counter() - t0
            bad = packed_diff(ndb, pdb)
            say(f"phase6 {name} DB ({ndb.nentries} entries): native pack "
                f"== Python parse + pack: {'bitwise' if not bad else bad}; "
                f"load native {t_native * 1e3:.1f} ms, Python "
                f"{t_python * 1e3:.1f} ms (host clock)")
            if bad:
                raise AssertionError(f"native and Python packs differ: {bad}")


def phase7(dev, out, card):
    from cuda_satabsearch_tpu_torch.core.warmup import add_one
    from cuda_satabsearch_tpu_torch.eval.acceptance_eval import (
        parity_rows, verdict)
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    say("phase7 acceptance vs the reference CPU oracle "
        "(tests/fixtures/refgolden/), 586-entry DB, SA kernel:")
    say("| query | n1 | restarts | spearman | top10 | top50 | auc5 | "
        "ms per query |")
    say("|---|---|---|---|---|---|---|---|")
    sa_search.launches = add_one.launches = 0
    rows = parity_rows((128, 4096), backend="cuda", device=str(dev))
    launches, warm = sa_search.launches, add_one.launches
    for qname, n1, r, rep, ms in rows:
        say(f"| {qname} | {n1} | {r} | {rep.spearman:.4f} | "
            f"{rep.top10:.2f} | {rep.top50:.2f} | {rep.auc5:.4f} | "
            f"{ms:.3f} |")
    passed, text = verdict(rows)
    say(f"phase7 gate: {text}; {launches} SA kernel and {warm} start-up "
        f"kernel launches; card {card}")
    if launches < 1 or warm < 1:
        raise AssertionError("the acceptance path did not run the kernels")
    if not passed:
        raise AssertionError("the acceptance gate failed")


def search_wall_ms(sess, query, reps=3):
    """Best wall ms of ``reps`` synchronised searches (results drained)."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.search(query, lsoln=True, query_tag=0)
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls)


def phase8(dev, out, card):
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    n = torch.cuda.device_count()
    meshes = {"[cuda:0, cuda:0]": [dev, dev],
              f"all {n} visible devices": [torch.device("cuda", i)
                                           for i in range(n)]}
    say(f"phase8 visible CUDA devices: {n}")
    query = read_query("d1ubia_.input")[0]
    for dbname, dbfile, entries in (
            ("586-entry", DB586, None),
            ("14291-entry synthetic", "<synthetic>",
             synthetic_entries(14291))):
        ref_sess = SearchSession(dbfile, SessionConfig(
            maxstart=128, device=str(dev)), entries=entries)
        ref = ref_sess.search(query, lsoln=True, query_tag=0)
        ref_ms = search_wall_ms(ref_sess, query)
        del ref_sess
        for mname, mesh in meshes.items():
            sess = SearchSession(dbfile, SessionConfig(
                maxstart=128, use_mesh=True, devices=mesh), entries=entries)
            sa_search.launches = 0
            got = sess.search(query, lsoln=True, query_tag=0)
            launches = sa_search.launches
            ms = search_wall_ms(sess, query)
            err = max(int(np.abs(got.scores - ref.scores).max()),
                      int(np.abs(got.ssemaps - ref.ssemaps).max()))
            say(f"phase8 {dbname} DB, mesh {mname}: sharded == unsharded "
                f"max |diff| {err} on scores and maps (tolerance 0); "
                f"{launches} SA kernel launches; per query (LSOLN, r=128, "
                f"best of 3, wall): sharded {ms:.3f} ms, unsharded "
                f"{ref_ms:.3f} ms; card {card}")
            if err:
                raise AssertionError(f"sharded search differs on {mname}")
            if launches < len(mesh):
                raise AssertionError("the sharded path did not launch the "
                                     "SA kernel on every shard")
            del sess


FRESH = r"""
import contextlib, io, json, re, sys, time
import torch
from cuda_satabsearch_tpu_torch import cli, session
from cuda_satabsearch_tpu_torch.core.warmup import SHAPE, add_one

if sys.argv[1] == "start-up kernel alone":
    def warm(dev, log=True):
        t0 = time.perf_counter()
        ok = bool((add_one(torch.zeros(SHAPE, device=dev)) == 1.0).all())
        dt = time.perf_counter() - t0
        print(f"# start-up on {dev}: start-up kernel alone "
              f"{dt * 1e3:.1f} ms", file=sys.stderr)
        return dt
    session.warm_backend = warm
text = sys.stdin.read()
runs = []
for _ in range(2):
    err = io.StringIO()
    sys.stdin = io.StringIO(text)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["-r", "128"])
    lines = err.getvalue().splitlines()
    runs.append(dict(rc=rc, startup=[l for l in lines
                                     if l.startswith("# start-up")],
                     search_ms=[float(m.group(1)) for m in (
                         re.search(r"search time ([0-9.]+) ms", l)
                         for l in lines) if m]))
print(json.dumps(runs))
"""


def phase9(dev, out, card):
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        text = fp.read()
    env = dict(os.environ, PYTHONPATH=ROOT)
    for variant in ("full start-up", "start-up kernel alone"):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", FRESH, variant],
                             input=text, capture_output=True, text=True,
                             cwd=FIXTURES, env=env, timeout=300)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"fresh process failed: {res.stderr}")
        runs = json.loads(res.stdout.strip().splitlines()[-1])
        for i, run in enumerate(runs):
            if run["rc"] != 0 or len(run["search_ms"]) != 1:
                raise AssertionError(f"CLI call {i} in a fresh process: "
                                     f"{run}")
        out.setdefault("fresh", {})[variant] = [
            r["search_ms"][0] for r in runs]
        say(f"phase9 fresh process, {variant}, two CLI calls on "
            f"d1ubia_.input -r 128: first search "
            f"{runs[0]['search_ms'][0]:.3f} ms, second "
            f"{runs[1]['search_ms'][0]:.3f} ms; start-up lines "
            f"{[r['startup'] for r in runs]}; process wall {wall:.1f} s; "
            f"card {card}")


def phase10(dev, out, card):
    from cuda_satabsearch_tpu_torch.eval import (acceptance_eval,
                                                 gumbel_fit_artifact,
                                                 make_eval_artifact)
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "eval")
        t0 = time.perf_counter()
        rc = make_eval_artifact.main(["--out", art])  # both rows
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"make_eval_artifact exited {rc}")
        with open(os.path.join(art, "runs.json")) as fp:
            runs = {r["label"]: r for r in json.load(fp)["rows"]}
        with open(os.path.join(art, "auc_table.txt")) as fp:
            table = fp.read().splitlines()
        with open(os.path.join(art, "timestab.tex")) as fp:
            timestab = [ln for ln in fp.read().splitlines() if " & " in ln]
        for ln in table + timestab:
            say(f"phase10 | {ln}")
        mean = float(re.search(r"mean AUC over \d+ queries: ([0-9.]+)",
                               table[-1]).group(1))
        outputs = {}
        for label, run in runs.items():
            with open(run["results"]) as fp:
                outputs[label] = HEADER.sub("", fp.read())
            say(f"phase10 make_eval_artifact row {label}: search "
                f"{run['seconds'] * 1e3:.3f} ms (the CLI's search time), "
                f"process {run['wall']:.1f} s, {run['launches']} SA kernel "
                f"launches")
        with open(JAX_XLA_OUT) as fp:
            same_as_jax = outputs["h100-cuda"] == HEADER.sub("", fp.read())
        say(f"phase10 make_eval_artifact: h100-cuda mean AUC {mean:.4f}, "
            f"bar >= {JAX_MEAN_AUC - 0.01:.4f} (the JAX package's "
            f"{JAX_MEAN_AUC} - 0.01); h100-cuda output == the JAX "
            f"package's committed XLA-engine output (header aside): "
            f"{same_as_jax}; {wall:.1f} s; card {card}")
        if runs["h100-cuda"]["launches"] < 1:
            raise AssertionError("make_eval_artifact's kernel row never "
                                 "launched the SA kernel")
        if runs["h100-torch"]["launches"] != 0:
            raise AssertionError("the plain-engine row launched the kernel")
        if not same_as_jax:
            raise AssertionError("the h100-cuda output differs from the JAX "
                                 "package's committed XLA-engine output")
        if outputs["h100-torch"] != outputs["h100-cuda"]:
            raise AssertionError("the kernel and plain-engine rows printed "
                                 "different results")
        say("phase10 h100-torch output == h100-cuda output (tolerance 0)")
        if mean < JAX_MEAN_AUC - 0.01:
            raise AssertionError(f"h100-cuda mean AUC {mean:.4f} too low")

        gdir = os.path.join(tmp, "gumbel")
        sa_search.launches = 0
        t0 = time.perf_counter()
        rc = gumbel_fit_artifact.main(["--out", gdir])
        wall, launches = time.perf_counter() - t0, sa_search.launches
        if rc != 0:
            raise AssertionError(f"gumbel_fit_artifact exited {rc}")
        with open(os.path.join(gdir, "gumbel_fit.json")) as fp:
            fits = json.load(fp)
        rows = fits["queries"]
        a, b, n = fits["pooled"]
        finite = all(np.isfinite(r[2]) and np.isfinite(r[3]) for r in rows)
        say(f"phase10 gumbel_fit_artifact: {len(rows)} queries at r="
            f"{fits['restarts']}, n per query {sorted({r[4] for r in rows})}"
            f", all finite: {finite}; pooled a = {a:.4f}, b = {b:.4f} over "
            f"{n} null scores, reference a = "
            f"{gumbel_fit_artifact.REF_A:.4f}, b = "
            f"{gumbel_fit_artifact.REF_B:.4f}; search "
            f"{fits['search_s'] * 1e3:.3f} ms, {launches} SA kernel "
            f"launches, {wall:.1f} s; card {card}")
        if launches < 1:
            raise AssertionError("gumbel_fit_artifact never launched the "
                                 "SA kernel")
        if len(rows) != 24 or not finite:
            raise AssertionError(f"Gumbel fit: {len(rows)} rows, finite "
                                 f"{finite}")

        adir = os.path.join(tmp, "acceptance")
        sa_search.launches = 0
        t0 = time.perf_counter()
        rc = acceptance_eval.main(["--out", adir])
        wall, launches = time.perf_counter() - t0, sa_search.launches
        with open(os.path.join(adir, "acceptance.md")) as fp:
            report = fp.read().splitlines()
        for ln in report:
            if ln.startswith(("|", "**")):
                say(f"phase10 acceptance | {ln}")
        say(f"phase10 acceptance_eval: exit {rc}, {launches} SA kernel "
            f"launches, {wall:.1f} s; card {card}")
        if launches < 1:
            raise AssertionError("acceptance_eval never launched the SA "
                                 "kernel")
        if rc != 0 or not any(ln.startswith("**Acceptance") and "PASS" in ln
                              for ln in report):
            raise AssertionError("the acceptance report's verdict is not "
                                 "PASS")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from cuda_satabsearch_tpu_torch.io import native
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import (find_nvcc,
                                                          load_library)

    dev = torch.device("cuda", 0)
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    # the native loader's g++ build runs beside the kernels' nvcc builds
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        native_so = pool.submit(native.build)
        lib = load_library()
        native_so = native_so.result()
    say(f"kernels built in {lib.build_s:.1f} s -> "
        f"{os.path.relpath(lib.path, ROOT)}; native DB loader -> "
        f"{os.path.relpath(native_so, ROOT)}; both in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    out, failed = {}, []
    errs = {}  # phase -> max |diff| against the plain version
    phases = (("phase0", phase0), ("phase1", phase1), ("phase2", phase2),
              ("phase3", phase3), ("phase4", phase4),
              ("phase5", lambda d, o: phase5(d, o, card)),
              ("phase6", phase6),
              ("phase7", lambda d, o: phase7(d, o, card)),
              ("phase8", lambda d, o: phase8(d, o, card)),
              ("phase9", lambda d, o: phase9(d, o, card)),
              ("phase10", lambda d, o: phase10(d, o, card)))
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            err = fn(dev, out)
            if err is not None:
                errs[name] = err
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            say(f"{name} FAILED")
            failed.append(name)
        say(f"({name}: {time.perf_counter() - t0:.1f} s)")
    sa_errs = [e for n, e in errs.items() if n != "phase0"]
    say(json.dumps({"kernels": [{
        "name": "sa_search", "route": "cuda",
        "source": "cuda_satabsearch_tpu_torch/csrc/sa_search.cu",
        "replaces": "cuda_satabsearch_tpu/ops/pallas_sa2.py:535",
        "launches": out.get("launches"),
        "max_abs_err": max(sa_errs) if sa_errs else None,
        "ms": out.get("ms"), "plain_ms": out.get("plain_ms")}, {
        "name": "add_one", "route": "cuda",
        "source": "cuda_satabsearch_tpu_torch/csrc/warmup.cu",
        "replaces": "cuda_satabsearch_tpu/core/warmup.py:51",
        "launches": out.get("warm_launches"),
        "max_abs_err": errs.get("phase0"),
        "ms": out.get("warm_ms"), "plain_ms": out.get("warm_plain_ms")}]}))
    if failed:
        say(f"FAILED: {failed}")
        return 1
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
