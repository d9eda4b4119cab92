"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernel library (the SA search kernel and the start-up
kernel) from cuda_satabsearch_tpu_torch/csrc/ with nvcc, one process per
source, while the native DB loader (native/satab_io.cpp) builds with
g++, and prints ptxas's registers, shared memory and spills, and each
launch class's CTAs per SM; holds each kernel against its plain PyTorch
version on the card, drives the port's main paths (the
``torchsatabsearch`` CLI, the acceptance gate, the sharded search) on
the 586-entry fixture DB, and times a 14291-entry ASTRAL-like synthetic
DB.  Phases:

0. start-up kernel vs x + 1 on f32[8, 128] and on an odd size: bitwise,
   both timed per call (CUDA events over a loop) and device-only
   (torch.profiler);
1. SA kernel vs its plain version (ops/engine.search_plan_plain) on a
   supplied stream: bitwise scores and maps, on launch plans that mix
   bucket widths 8-112 in both launch classes with padding rows, K 1-3
   queries of mixed orders, LORDER / LSOLN T/F, c_par 100 / 128, r_seq
   1 / 3, and c_par 128 x r_seq 32 (the r = 4096 split), whose
   launches split the restarts over CTAs (ops/sa_kernel.restart_split;
   split launches counted); the unsplit cases' small plans run each
   chain on several lanes (ops/sa_kernel.chain_lanes; lane launches
   counted, the lanes per launch class printed);
2. the same cases on the seeded stream: the kernel derives every key
   from (seed, tag, file-order index) itself, the plain version takes
   them from ops/rng.entry_keys: bitwise, split and lane launches
   counted, and the share of the screened warp-moves that took the
   exact log (``sa_kernel.exact_log_share``) printed; ``ln_f32`` on the
   card against the CPU, and the table of exact logs that the kernel
   reads (``sa_kernel.LN_GRIDS``, made by ``sa_ln_grid`` once per
   device) bitwise ``ops/rng.ln_f32`` over all 2**23 grid values;
3. CLI main path, d1ubia_ query vs the 586-entry DB at r=128: the
   reference's top 3, scores equal to the plain engine's on the card,
   at most two SA launches and the start-up kernel's launch; the
   profiler's device launches of one ``search``, none of them a torch
   kernel before the first SA launch; queries of 25-40 SSEs against the
   same DB launched as the main path launches them (wide class on 4
   lanes per chain, narrow on 2): bitwise equal to the plain engine on
   both streams;
4. multiquery.input (8/13/101-SSE queries): batched search_many equals
   per-query search, bitwise;
5. timings, in one process: one plan per bucket in series (the schedule
   before launch plans) against the full plan (two launches), per
   bucket and in all on the 586-entry DB (CUDA events) with the plain
   version, and the wall and device idle share of a whole search on the
   586-entry and the 14291-entry synthetic DB;
6. native DB loader vs Python parse + pack, bitwise, on the 586-entry
   fixture and on the synthetic DB written by io/writer.py, both timed;
7. acceptance gate: d1ubia_, d1ae6h1 and d2phlb1 at r = 128 and
   r = 4096 on the kernel against the reference CPU oracle's outputs
   (tests/fixtures/refgolden/), ranked by norm2; d2phlb1 at r = 4096
   must reach auc5 >= 0.9815 (its launches split);
8. sharded vs unsharded search, bitwise on scores and maps, on the mesh
   [cuda:0, cuda:0] and on all visible devices, on both DBs, timed;
9. the first and second search of fresh processes running the CLI on
   d1ubia_.input, with the full start-up (the first must take at most
   twice the second) and with the start-up kernel alone;
10. the evaluation path on the card: the three evaluation drivers of
   cuda_satabsearch_tpu_torch/eval/ into a temporary directory.
   ``make_eval_artifact`` runs multiquery.input through the CLI in a
   subprocess (the kernel row must reach a mean AUC within 0.01 of the
   JAX package's 0.9796 and print, header aside, the JAX package's
   committed XLA-engine output byte for byte), ``gumbel_fit_artifact``
   fits 24 queries at r = 4096 (24 finite rows), ``acceptance_eval``
   writes its report (verdict PASS); the SA kernel's launch counter must
   move in each;
11. the structure-to-hits path: (a) 586 synthetic PDB structures
   (cuda_satabsearch_tpu_torch/synthetic.py, seeded) built by
   ``python -m cuda_satabsearch_tpu_torch.build -s -o`` in one child
   process, each read back with its SSE count, the native pack of the
   built DB == the Python pack; (b) three built entries (about 8, 13
   and 19 SSEs) searched with LSOLN at r = 128 in one CLI process: each
   self-hit tops its column, at most 2 SA launches per round8 group;
   (c) the kernel == ops/golden.sa_chain per chain, bitwise, on supplied
   uniforms (widths 8-112, n1 5/8/13/19, LORDER T/F; c_par 8 x r_seq 2,
   split); (d) ``tools.tophits`` writes 10 bundles per query (the self-hit at
   rmsd < 0.001 A where its map is the identity) and ``tools.ssemap``
   the HTML report; (e) the SA kernel's rate per bucket width (the
   numbers of ops/balance.py's RATE_M_IT_S) and balance_report's
   per-shard prediction against large14291's shard on [cuda:0, cuda:0];
   (f) ``graft_entry.entry()``, ``dryrun_multichip`` on every visible
   card and on 2 shards, and ``latency_budget``'s split of a warm query
   by the program's spans;
12. the benchmark runner and the stream: (a) ``python -m
   cuda_satabsearch_tpu_torch.bench`` at its defaults (the three shapes
   of the root bench.py) in a child process: one JSON line with the
   root bench's keys, the reference's top 3 in its 586db per-query
   search, both kernels launched; (b) ``bench --paritycheck --out``:
   PASS, the root PARITY.json untouched; (c) 65,536 queries of one
   round8 group in one ``search_many`` (more than one launch's grid
   takes): at most 2 x ceil(65,536 / K_TILE) launches, sampled queries
   == single searches; (d) the CLI on multiquery.input in this process:
   the JAX package's committed output, 6 SA launches, one drain after
   all of them; (e) the query tile's A/B on the 586db stream of 384
   queries (tiles of 64, 128, 256 and one of 384, interleaved).

Prints one line per phase, then a JSON line with the kernels' numbers
(launches on the main path, error against the plain version, times,
the bound and what sets it), then ``{"ok": true, "device": {...}}`` as
the last line.  Exits non-zero without that line when there is no CUDA
device or any phase fails.
"""

import ast
import collections
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
    """The card's name and power limit, as nvidia-smi gives them."""
    from cuda_satabsearch_tpu_torch.bench import card_line

    return card_line()


def random_entry(rng, n, name):
    """A random valid entry (symmetric tableau, consistent diagonals)."""
    from cuda_satabsearch_tpu_torch.synthetic import random_entry

    return random_entry(rng, n, name)


@functools.lru_cache(maxsize=None)
def synthetic_entries(n):
    """ASTRAL-2.07-like SSE-count mix (median ~10, tail to 111): the
    generator of bench.py (which imports the JAX package), made once
    per size."""
    from cuda_satabsearch_tpu_torch.synthetic import astral_entries

    return astral_entries(n)


def read_query(name):
    from cuda_satabsearch_tpu_torch.io.pack import pack_query
    from cuda_satabsearch_tpu_torch.io.parser import parse_search_input

    with open(os.path.join(FIXTURES, name)) as fp:
        return [pack_query(q) for q in parse_search_input(fp).queries]


# the widths of a case's plan: a narrow and one or two wide buckets,
# cycling so that every width of both classes is covered
PLAN_WIDTHS = ((8, 48), (16, 64, 112), (24, 80), (32, 48, 112), (8, 64),
               (16, 80, 112), (24, 48), (32, 64, 80))


def kernel_cases(dev):
    """Random (queries, plan) problems at the main path's shapes: launch
    plans over two or three buckets, both launch classes, 2 or 3
    entries per bucket padded to 3 rows (padding rows included), query
    orders n1, each of the 16 combinations of LORDER, LSOLN, c_par and
    r_seq once with K = 1, 2 or 3, then two cases at c_par 128 x r_seq
    32 (the acceptance gate's r = 4096)."""
    from cuda_satabsearch_tpu_torch.io.pack import pack_database, pack_query
    from cuda_satabsearch_tpu_torch.ops.common import round8
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (
        make_plan, pack_queries, prepare_bucket)

    rng = np.random.default_rng(2024)
    combos = [(*c, (1, 2, 3)[i % 3]) for i, c in enumerate(itertools.product(
        (True, False), (True, False), (128, 100), (1, 3)))]
    n1s = (5, 8, 13, 19, 101)
    pairs = [((PLAN_WIDTHS[i % len(PLAN_WIDTHS)], n1s[i % len(n1s)]), c)
             for i, c in enumerate(combos)]
    pairs += [(((16, 112), 19), (True, True, 128, 32, 1)),
              (((8, 48), 13), (False, False, 128, 32, 3))]
    for ci, ((widths, n1), combo) in enumerate(pairs):
        lorder, lsoln, c_par, r_seq, K = combo
        n1r = round8(n1)
        orders = [n1, max(n1r - 7, 2), n1r][:K]
        queries = [pack_query(random_entry(rng, o, f"q{k}"))
                   for k, o in enumerate(orders)]
        caps = (8, 16, 24, 32, 48, 64, 80, 112)
        entries = []
        for d2 in widths:
            lo = caps[caps.index(d2) - 1] + 1 if d2 > 8 else 2
            for _ in range(int(rng.integers(2, 4))):
                o = int(rng.integers(lo, min(d2, 111) + 1))
                entries.append(random_entry(rng, o, f"e{len(entries)}"))
        rng.shuffle(entries)
        db = pack_database(entries, pad_to=3)
        plan = make_plan([prepare_bucket(b, dev) for b in db.buckets])
        q = pack_queries(queries, n1r, dev)
        yield ci, dict(lorder=lorder, lsoln=lsoln, c_par=c_par, r_seq=r_seq,
                       K=K, widths=widths, n1=n1), q, plan


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


def device_events(fn):
    """The device activities (kernels and copies) of one call of
    ``fn()``, synchronised, in torch.profiler's trace: [(start_us,
    end_us, name)] sorted by start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def busy_us(events) -> float:
    """Device busy time: the union of the events' intervals (the two
    launch classes of a plan run at the same time)."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in events:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


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


def case_lanes(cfg, q, plan) -> tuple:
    """The lanes per chain of each launch class (wide first) of a kernel
    case's launches (ops/sa_kernel.launch_shape)."""
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import launch_shape

    return launch_shape(plan, cfg["K"], q[0].shape[1], c_par=cfg["c_par"],
                        r_seq=cfg["r_seq"], lsoln=cfg["lsoln"])[1]


def phase1(dev, out):
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.common import slots_per_restart
    from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    urng = np.random.default_rng(7)
    worst, n, launches = 0, 0, 0
    splits, lanes = sa_search.split_launches, sa_search.lane_launches
    by_case = collections.Counter()
    for ci, cfg, q, plan in kernel_cases(dev):
        by_case[case_lanes(cfg, q, plan)] += 1
        n1r = q[0].shape[1]
        P = slots_per_restart(n1r)
        shape = (cfg["K"], plan.nentries, cfg["r_seq"], P, cfg["c_par"])
        u = torch.from_numpy(urng.random(shape, dtype=np.float32)).to(dev)
        u = rng.log_acc_slots(u, n1r).contiguous()
        kw = dict(c_par=cfg["c_par"], r_seq=cfg["r_seq"],
                  lorder=cfg["lorder"], lsoln=cfg["lsoln"])
        before = sa_search.launches
        got = sa_search(*q, plan, uniforms=u, **kw)
        torch.cuda.synchronize()
        launches = max(launches, sa_search.launches - before)
        ref = search_plan_plain(*q, plan, uniforms=u, **kw)
        err = compare(got, ref)
        if err:
            raise AssertionError(f"phase1 case {ci} {cfg}: max |diff| {err}")
        worst, n = max(worst, err), n + 1
    splits = sa_search.split_launches - splits
    lanes = sa_search.lane_launches - lanes
    say(f"phase1 supplied stream, plan kernel == plain plan on the card: "
        f"{n} cases (plans of widths {sorted(set(itertools.chain(*PLAN_WIDTHS)))}"
        f", both classes, padding rows), max |diff| {worst} (tolerance 0: "
        f"bitwise); at most {launches} launches per plan, {splits} of the "
        f"launches with their restarts split, {lanes} with lanes; cases by "
        f"lanes per chain (wide, narrow): {dict(by_case)}")
    if launches != 2:
        raise AssertionError("a two-class plan did not take two launches")
    if not splits:
        raise AssertionError("no launch split its restarts")
    if not lanes:
        raise AssertionError("no launch ran a chain on several lanes")
    return worst


def phase2(dev, out):
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import (LN_GRIDS,
                                                          device_index,
                                                          exact_log_counts,
                                                          exact_log_share,
                                                          ln_grid, sa_search)

    worst, n = 0, 0
    counts = exact_log_counts()
    splits, lanes = sa_search.split_launches, sa_search.lane_launches
    by_case = collections.Counter()
    for ci, cfg, q, plan in kernel_cases(dev):
        by_case[case_lanes(cfg, q, plan)] += 1
        # tags beyond 2**31 too: the kernel takes their uint32 bits
        tags = [ci, 2 ** 31 + ci, 2 ** 32 + 7][:cfg["K"]]
        kw = dict(seed=1234 + ci, tags=tags, c_par=cfg["c_par"],
                  r_seq=cfg["r_seq"], lorder=cfg["lorder"],
                  lsoln=cfg["lsoln"])
        got = sa_search(*q, plan, **kw)
        torch.cuda.synchronize()
        ref = search_plan_plain(*q, plan, **kw)
        err = compare(got, ref)
        if err:
            raise AssertionError(f"phase2 case {ci} {cfg}: max |diff| {err}")
        worst, n = max(worst, err), n + 1
    splits = sa_search.split_launches - splits
    lanes = sa_search.lane_launches - lanes
    exact, screened = (a - b for a, b in zip(exact_log_counts(), counts))
    say(f"phase2 seeded stream, keys derived in the kernel == plain plan on "
        f"ops/rng.entry_keys' stream (ln_f32 on the card): {n} cases, max "
        f"|diff| {worst} (tolerance 0: bitwise); {splits} split launches, "
        f"{lanes} with lanes; cases by lanes per chain (wide, narrow): "
        f"{dict(by_case)}; the Metropolis screen sent {exact} of {screened} "
        f"warp-moves to the exact log (exact_log_share "
        f"{exact_log_share(counts)})")
    if not splits:
        raise AssertionError("no launch split its restarts")
    if not lanes:
        raise AssertionError("no launch ran a chain on several lanes")
    # ln u on the card vs on the CPU over every uniform (k * 2**-23):
    # where they differ, -c and the card may part ways; the kernel's
    # table of exact logs has to be the CPU's bit for bit
    grid = torch.arange(2 ** 23, dtype=torch.float64).mul_(
        2.0 ** -23).float()
    want = rng.ln_f32(grid)
    diff = int((rng.ln_f32(grid.to(dev)).cpu() != want).sum())
    table = LN_GRIDS[device_index(dev)].cpu()
    table_diff = int((table != want).sum())
    out["ln_grid_launches"] = ln_grid.launches
    # ln 0 = -inf at k = 0 on both sides
    out["ln_grid_err"] = float((table[1:] - want[1:]).abs().max())
    say(f"phase2 ln_f32 card vs CPU over {grid.numel()} uniform grid "
        f"values: {diff} differ; the kernel's table (sa_ln_grid, "
        f"{ln_grid.launches} launch(es) for {len(LN_GRIDS)} device(s)) "
        f"vs ln_f32 on the CPU: {table_diff} differ (tolerance 0: bitwise)")
    if not torch.equal(table, want):
        raise AssertionError(f"the table of exact logs differs from ln_f32 "
                             f"in {table_diff} grid values")
    if ln_grid.launches != len(LN_GRIDS):
        raise AssertionError("sa_ln_grid was not launched once per device")
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
    if not 1 <= launches <= 2:
        raise AssertionError(f"the CLI query took {launches} SA kernel "
                             f"launches (1 or 2 expected)")
    if warm_launches < 1:
        raise AssertionError("the CLI never launched the start-up kernel")
    prof = in_fresh_process("profile_one_search")
    out["device_launches"] = prof["launches"]
    if prof["before"]:
        raise AssertionError(f"torch kernels run before the SA kernel: "
                             f"{prof['before']}")
    if prof["sa_kernels"] != 2:
        raise AssertionError(f"{prof['sa_kernels']} SA kernels in one "
                             f"search (2 expected)")
    query = read_query("d1ubia_.input")[0]
    plain = SearchSession(DB586, SessionConfig(maxstart=128, backend="torch",
                                                device=str(dev)))
    ref = plain.search(query, lorder=True, lsoln=False, query_tag=0)
    diff = int(np.abs(ref.scores - scores).max())
    say(f"phase3 CLI scores vs the plain engine on the card: max |diff| "
        f"{diff} (tolerance 0)")
    if diff:
        raise AssertionError("kernel and plain scores differ on the CLI path")
    return max(diff, phase3_lanes(dev))


def phase3_lanes(dev):
    """Queries of 25-32 and 33-40 SSEs (both query mask widths) against
    the 586-entry DB at r = 128 with LSOLN, as the main path launches
    them: the wide class on 4 lanes per chain and the narrow one on 2
    (ops/sa_kernel.launch_shape), scores and maps bitwise equal to the
    plain engine on a supplied and on the seeded stream."""
    from cuda_satabsearch_tpu_torch.ops import rng
    from cuda_satabsearch_tpu_torch.ops.common import (round8,
                                                       slots_per_restart)
    from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
    from cuda_satabsearch_tpu_torch.ops.kernel_search import pack_queries
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import (launch_shape,
                                                          sa_search)
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    sess = SearchSession(DB586, SessionConfig(maxstart=128, device=str(dev)))
    (plan,) = sess.device_db
    urng = np.random.default_rng(17)
    worst, seen = 0, []
    for lo, hi in ((25, 32), (33, 40)):
        name, n1 = next((nm, int(o)) for nm, o in zip(sess.db.names,
                                                       sess.db.orders)
                        if lo <= o <= hi)
        n1r = round8(n1)
        shape = launch_shape(plan, 1, n1r, c_par=128, r_seq=1, lsoln=True)
        seen.append((name, n1, shape))
        if shape != (1, (4, 2)):
            raise AssertionError(f"{name} ({n1} SSEs): (S, lanes) {shape}, "
                                 f"not (1, (4, 2))")
        q = pack_queries([sess.resolve_query(name)], n1r, dev)
        u = torch.from_numpy(urng.random(
            (1, plan.nentries, 1, slots_per_restart(n1r), 128),
            dtype=np.float32)).to(dev)
        for kw in (dict(uniforms=rng.log_acc_slots(u, n1r).contiguous()),
                   dict(seed=2 ** 31 - 5, tags=[n1])):
            kw.update(c_par=128, r_seq=1, lorder=True, lsoln=True)
            before = sa_search.launches, sa_search.lane_launches
            got = sa_search(*q, plan, **kw)
            torch.cuda.synchronize()
            counts = (sa_search.launches - before[0],
                      sa_search.lane_launches - before[1])
            err = compare(got, search_plan_plain(*q, plan, **kw))
            if counts != (2, 2) or err:
                raise AssertionError(f"{name}: (launches, lane launches) "
                                     f"{counts}, max |diff| {err}")
            worst = max(worst, err)
    say(f"phase3 lanes on the main path, 586 entries, r = 128, LSOLN, "
        f"(query, SSEs, (S, (wide, narrow) lanes)) {seen}: kernel == plain "
        f"engine on a supplied and the seeded stream, max |diff| {worst} "
        f"(tolerance 0: bitwise), 2 launches and 2 lane launches each")
    return worst


def in_fresh_process(task: str) -> dict:
    """Run ``task()`` of this file in a fresh process on the card, relay
    its lines and return the JSON object it prints last.  torch.profiler
    is used there: in one run of this script, profiles taken after
    phases 1-2 recorded none or part of a search's device activities,
    while a fresh process recorded all of them."""
    res = subprocess.run([sys.executable, "-c",
                          f"import chip_smoke; chip_smoke.{task}()"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"{task} failed in a fresh process:\n"
                             f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    for line in lines[:-1]:
        say(line)
    return json.loads(lines[-1])


def profile_one_search():
    """The device activities of one warm search (586 entries, d1ubia_,
    r = 128) in torch.profiler; prints a JSON summary last."""
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    query = read_query("d1ubia_.input")[0]
    sess = SearchSession(DB586, SessionConfig(maxstart=128, device="cuda:0"))
    sess.search(query, lsoln=False, query_tag=0)
    events = device_events(lambda: sess.search(query, lsoln=False,
                                               query_tag=0))
    names = [n for _, _, n in events]
    sa = [i for i, n in enumerate(names) if "sa_plan_kernel" in n]
    before = [n for n in names[:sa[0] if sa else len(names)]
              if not is_copy(n)]
    kernels = [n for n in names if not is_copy(n)]
    say(f"phase3 one search (586 entries, r=128) in torch.profiler, fresh "
        f"process: {len(events)} device launches ({len(kernels)} kernels, "
        f"{len(events) - len(kernels)} copies): {[n[:40] for n in names]}; "
        f"torch kernels before the first SA launch: {len(before)}")
    print(json.dumps({"launches": len(events), "sa_kernels": len(sa),
                      "before": before}))


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


# Operation count of the SA search, for its bound (int32 operations):
# one threefry2x32 draw is 20 rounds of add, rotate and xor (60), 5 key
# injections (15), 2 initial adds and 3 operations to make the float;
# a move is three draws and, per query SSE, ~8 operations of the delta;
# a restart adds a key, n1 thinit draws and ~8 per pair of the initial
# score.
THREEFRY_OPS = 80
DELTA_OPS = 8
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate (NVIDIA H100 datasheet)
INT32_LANES = 64  # INT32 lanes per SM (Hopper architecture white paper)


def max_sm_clock_mhz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0])


def sa_bound(plan, n1s, c_par, r_seq, lsoln, maxiter=100):
    """(bound ms, "operations" or "bytes", int32 ops, bytes) of one SA
    search of queries of orders ``n1s`` against ``plan``: its int32
    operations over SMs x INT32_LANES x the maximum SM clock, and its
    bytes (each input read once, each output written once) over
    HBM_BYTES_S; the larger sets the bound.  Only real entries count:
    padding rows are not work the data needs."""
    from cuda_satabsearch_tpu_torch.ops.common import round8

    nreal = int((plan.index >= 0).sum())
    per_restart = sum(maxiter * (3 * THREEFRY_OPS + DELTA_OPS * n1)
                      + (n1 + 1) * THREEFRY_OPS + 4 * n1 * n1 for n1 in n1s)
    ops = nreal * c_par * r_seq * per_restart
    n1r, K = round8(max(n1s)), len(n1s)
    nbytes = sum(len(b.index) * (b.dim + 5 * b.dim * b.dim + 8)
                 for b in plan.buckets)
    nbytes += K * (n1r + 5 * n1r * n1r + 8)
    nbytes += K * plan.nentries * 4 * (1 + (n1r if lsoln else 0))
    props = torch.cuda.get_device_properties(0)
    t_ops = ops / (props.multi_processor_count * INT32_LANES
                   * max_sm_clock_mhz() * 1e6)
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def schedules(sess):
    """{schedule: plans} of one session's single shard: one plan per
    bucket, in series (the schedule before launch plans), and the full
    plan."""
    from cuda_satabsearch_tpu_torch.ops.kernel_search import make_plan

    (full,) = sess.device_db
    return {"one plan per bucket": [make_plan([b]) for b in full.buckets],
            "full plan": [full]}


def time_schedules(name, sess, query, card):
    """Kernel time (CUDA events), search wall and device idle share of
    both schedules, in turns (per bucket, full, full, per bucket)."""
    from cuda_satabsearch_tpu_torch.ops.kernel_search import pack_queries
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.ops.search import search_db_many

    dev = sess.device
    q = pack_queries([query], 8, dev)
    kw = dict(seed=1234, tags=[0], c_par=128, r_seq=1, lorder=True,
              lsoln=False)
    res, by_label = {}, schedules(sess)
    for label in ("one plan per bucket", "full plan", "full plan",
                  "one plan per bucket"):
        plans = by_label[label]

        def kernels():
            for plan in plans:
                sa_search(*q, plan, **kw)

        def search():
            search_db_many([query], sess.db, plans, query_tags=[0],
                           maxstart=128, lorder=True, lsoln=False, seed=1234)

        ms = cuda_ms(kernels, 20)
        search()
        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search()  # ends in the drain
            walls.append((time.perf_counter() - t0) * 1e3)
        events = device_events(search)
        wall = float(np.median(walls))
        idle = 1.0 - busy_us(events) / 1e3 / wall
        res.setdefault(label, []).append((ms, wall, idle, len(events)))
    for label, rows in res.items():
        say(f"phase5 {name}, {label} ({len(by_label[label])} plans): "
            f"kernels {' / '.join(f'{r[0]:.4f}' for r in rows)} ms "
            f"(CUDA events, 20 reps); search wall median of 7 "
            f"{' / '.join(f'{r[1]:.4f}' for r in rows)} ms; device idle "
            f"share {' / '.join(f'{r[2]:.3f}' for r in rows)}; "
            f"{rows[0][3]} device launches; card {card}")
    return res


def profile_schedules():
    """time_schedules on the 586-entry and the 14291-entry DB; prints
    {db: {schedule: [(kernel ms, wall ms, idle share, launches)]}}
    last."""
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    card = card_line()
    query = read_query("d1ubia_.input")[0]
    res = {}
    for name, dbfile, entries in (
            ("586 entries", DB586, None),
            ("14291 entries", "<synthetic>", synthetic_entries(14291))):
        sess = SearchSession(dbfile, SessionConfig(maxstart=128,
                                                   device="cuda:0"),
                             entries=entries)
        res[name] = time_schedules(name, sess, query, card)
    print(json.dumps(res))


def phase5(dev, out, card):
    from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (make_plan,
                                                              pack_queries)
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    query = read_query("d1ubia_.input")[0]
    sess = SearchSession(DB586, SessionConfig(maxstart=128, device=str(dev)))
    (full,) = sess.device_db
    q = pack_queries([query], 8, dev)
    kw = dict(seed=1234, tags=[0], c_par=128, r_seq=1, lorder=True,
              lsoln=False)
    # plain, kernel, kernel, plain: the full plan, one query
    p1 = cuda_ms(lambda: search_plan_plain(*q, full, **kw), 2)
    k1 = cuda_ms(lambda: sa_search(*q, full, **kw), 20)
    k2 = cuda_ms(lambda: sa_search(*q, full, **kw), 20)
    p2 = cuda_ms(lambda: search_plan_plain(*q, full, **kw), 2)
    out["ms"], out["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    bound, by, ops, nbytes = sa_bound(full, [query.order], 128, 1, False)
    out["bound_ms"], out["bound_by"] = bound, by
    it586 = sess.nentries * 128 * 100
    say(f"phase5 586 entries, 8-SSE query, r=128, the full plan: kernel "
        f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (CUDA "
        f"events); kernel {it586 / (k1 + k2) * 2e-3:.1f} M it/s; bound "
        f"{bound:.4f} ms set by {by} ({ops} int32 ops at "
        f"{max_sm_clock_mhz():.0f} MHz max SM clock, {nbytes} bytes), "
        f"share of bound {bound / out['ms']:.4f}; card {card}")
    cells = []
    for b in full.buckets:
        plan = make_plan([b])
        cells.append(f"d2 {b.dim} x {plan.nentries}: "
                     f"{cuda_ms(lambda: sa_search(*q, plan, **kw), 10):.4f}")
    say(f"phase5 586 entries, one plan per bucket alone (CUDA events, 10 "
        f"reps, ms): {'; '.join(cells)}")

    t0 = time.perf_counter()
    big = SearchSession("<synthetic>", SessionConfig(maxstart=128,
                                                     device=str(dev)),
                        entries=synthetic_entries(14291))
    say(f"phase5 synthetic DB: {big.nentries} entries built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    (bfull,) = big.device_db
    cells = []
    for b in bfull.buckets:
        plan = make_plan([b])
        cells.append(f"d2 {b.dim} x {plan.nentries}: "
                     f"{cuda_ms(lambda: sa_search(*q, plan, **kw), 10):.4f}")
    say(f"phase5 14291 entries, one plan per bucket alone (CUDA events, 10 "
        f"reps, ms): {'; '.join(cells)}")
    res = in_fresh_process("profile_schedules")
    out["large_ms"] = min(r[1] for r in res["14291 entries"]["full plan"])
    it = big.nentries * 128 * 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.search_many([query] * 8, lsoln=False)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    say(f"phase5 14291 entries, 8-SSE query, r=128: best search wall "
        f"{out['large_ms']:.4f} ms, {it / out['large_ms'] / 1e3:.1f} M it/s; "
        f"8 queries batched {wall8 * 1e3:.3f} ms, "
        f"{8 * it / wall8 / 1e6:.1f} M it/s; card {card}")


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
    splits = sa_search.split_launches
    rows = parity_rows((128, 4096), backend="cuda", device=str(dev))
    launches, warm = sa_search.launches, add_one.launches
    splits = sa_search.split_launches - splits
    for qname, n1, r, rep, ms in rows:
        say(f"| {qname} | {n1} | {r} | {rep.spearman:.4f} | "
            f"{rep.top10:.2f} | {rep.top50:.2f} | {rep.auc5:.4f} | "
            f"{ms:.3f} |")
    passed, text = verdict(rows)
    say(f"phase7 gate: {text}; {launches} SA kernel ({splits} of them "
        f"split) and {warm} start-up kernel launches; card {card}")
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
        first, second = (r["search_ms"][0] for r in runs)
        out.setdefault("fresh", {})[variant] = [first, second]
        say(f"phase9 fresh process, {variant}, two CLI calls on "
            f"d1ubia_.input -r 128: first search "
            f"{runs[0]['search_ms'][0]:.3f} ms, second "
            f"{runs[1]['search_ms'][0]:.3f} ms; start-up lines "
            f"{[r['startup'] for r in runs]}; process wall {wall:.1f} s; "
            f"card {card}")
        if variant == "full start-up" and first > 2 * second:
            raise AssertionError(f"a fresh process's first search took "
                                 f"{first:.3f} ms, over twice its second")


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


NSTRUCT = 586  # the bundled DB's scale
QUERY_SIZES = (8, 13, 19)  # PERF.md's acceptance query sizes
WIDTHS = (8, 16, 24, 32, 48, 64, 80, 112)  # io/pack.DEFAULT_BUCKETS


def run_module(module, argv, stdin=None, cwd=ROOT, timeout=600):
    """``python -m module argv`` in a child process: (stdout, stderr,
    wall s); fails unless it exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *argv], input=stdin,
                         capture_output=True, text=True, cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{module} {argv} exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    return res.stdout, res.stderr, wall


def width_range(d2):
    """SSE counts that pack into the bucket of width ``d2``."""
    return (WIDTHS[WIDTHS.index(d2) - 1] + 1 if d2 > 8 else 2), min(d2, 111)


def phase11(dev, out, card):
    """The structure-to-hits path: build, search with LSOLN, golden
    lockstep, top hits (steps a-d, in one temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        entries = phase11a(tmp, card)
        qids, lsoln_out = phase11b(tmp, entries, card)
        phase11c(dev, tmp, entries)
        phase11d(tmp, qids, lsoln_out, card)


def phase11a(tmp, card):
    """586 synthetic PDB structures -> the build CLI in one child
    process; the native pack of the built DB == the Python pack."""
    from cuda_satabsearch_tpu_torch.io import native
    from cuda_satabsearch_tpu_torch.io.pack import pack_database
    from cuda_satabsearch_tpu_torch.io.parser import read_database
    from cuda_satabsearch_tpu_torch.synthetic import write_pdb_tree

    t0 = time.perf_counter()
    counts = write_pdb_tree(os.path.join(tmp, "pdb"), NSTRUCT, seed=586)
    t_gen = time.perf_counter() - t0
    built = os.path.join(tmp, "built.ascii")
    _, err, t_build = run_module("cuda_satabsearch_tpu_torch.build",
                                 ["-s", "-o", built,
                                  os.path.join(tmp, "pdb")])
    entries = read_database(built)
    got = {e.name: e.order for e in entries}
    ndb = native.pack_database_file(built)
    bad = packed_diff(ndb, pack_database(entries))
    sizes = np.array(sorted(got.values()))
    say(f"phase11a {len(counts)} synthetic PDB structures (SSE counts "
        f"{sizes[0]}-{sizes[-1]}, median {int(np.median(sizes))}) written in "
        f"{t_gen:.2f} s; build CLI (-s -o, one child process) "
        f"{t_build:.2f} s wall (host clock): {err.strip().splitlines()[-1]};"
        f" native pack == Python pack: {'bitwise' if not bad else bad}; "
        f"card {card}")
    if got != counts:
        raise AssertionError("built SSE counts differ from the structures'")
    if bad:
        raise AssertionError(f"native and Python packs differ: {bad}")
    return entries


def phase11b(tmp, entries, card):
    """Three built entries (about 8, 13, 19 SSEs) searched with LSOLN in
    one CLI process at r = 128: each self-hit tops its column."""
    from cuda_satabsearch_tpu_torch.io.writer import format_entry
    from cuda_satabsearch_tpu_torch.ops.common import round8
    from cuda_satabsearch_tpu_torch.tools.ssemap import iter_ssemap_output

    queries = [min(entries, key=lambda e: (abs(e.order - n), e.name))
               for n in QUERY_SIZES]
    text = (f"{os.path.join(tmp, 'built.ascii')}\nT T T\n"
            + "".join(format_entry(q) for q in queries))
    stdout, err, wall = run_module("cuda_satabsearch_tpu_torch",
                                   ["-r", "128"], stdin=text, cwd=tmp)
    with open(os.path.join(tmp, "lsoln.out"), "w") as fp:
        fp.write(stdout)
    search_ms = float(re.search(r"search time ([0-9.]+) ms", err).group(1))
    launches = int(re.search(r"(\d+) SA kernel launches", err).group(1))
    groups = len({round8(q.order) for q in queries})
    hits = list(iter_ssemap_output(io.StringIO(stdout)))
    tops = []
    for q in queries:
        mine = {h.name: h for h in hits if h.query == q.name}
        best = max(h.score for h in mine.values())
        me = mine[q.name]
        identity = me.ssemap == [(k, k) for k in range(1, q.order + 1)]
        tops.append((q.name, q.order, me.score, best, identity))
    say(f"phase11b CLI -r 128 LSOLN, 3 queries {[t[:2] for t in tops]} vs "
        f"{len(entries)} built entries in one process: search "
        f"{search_ms:.3f} ms (the CLI's search time), process {wall:.2f} s; "
        f"{launches} SA kernel launches for {groups} round8 groups; "
        f"(query, self score, column top, self map identity): "
        f"{[(t[0], t[2], t[3], t[4]) for t in tops]}; card {card}")
    if len(hits) != 3 * len(entries):
        raise AssertionError(f"{len(hits)} hits parsed")
    if not 1 <= launches <= 2 * groups:
        raise AssertionError(f"{launches} SA launches for {groups} groups")
    if any(score < best for _, _, score, best, _ in tops):
        raise AssertionError(f"a self-hit is not on top: {tops}")
    return [q.name for q in queries], stdout


def phase11c(dev, tmp, entries):
    """Kernel == golden.sa_chain per chain, bitwise, on supplied
    uniforms: widths 8/16/32/48/80/112 (a built and a random entry each),
    queries of 5, 8, 13 and 19 built SSEs, LORDER T and F, LSOLN."""
    from cuda_satabsearch_tpu_torch.build.builder import build_from_file
    from cuda_satabsearch_tpu_torch.io.pack import pack_database, pack_query
    from cuda_satabsearch_tpu_torch.ops import golden, rng
    from cuda_satabsearch_tpu_torch.ops.common import round8, slots_per_restart
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (
        make_plan, pack_queries, prepare_bucket)
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.synthetic import synthetic_pdb

    r = np.random.default_rng(1111)
    # built structures wider than the 586 hold: 72 and 100 SSEs
    extra = []
    for nsse in (72, 100):
        path = os.path.join(tmp, f"wide{nsse}.ent")
        with open(path, "w") as fp:
            fp.write(synthetic_pdb(r, "".join(r.choice(["H", "E"], nsse))))
        extra.append(build_from_file(path, name=f"wide{nsse}"))
    pool = list(entries) + extra
    db_entries = []
    for d2 in (8, 16, 32, 48, 80, 112):
        lo, hi = width_range(d2)
        fits = [e for e in pool if lo <= e.order <= hi]
        if not fits:
            raise AssertionError(f"no built entry of {lo}-{hi} SSEs")
        db_entries.append(fits[int(r.integers(len(fits)))])
        db_entries.append(random_entry(r, int(r.integers(lo, hi + 1)),
                                       f"rand{d2}"))
    db = pack_database(db_entries)
    plan = make_plan([prepare_bucket(b, dev) for b in db.buckets])
    c_par, r_seq = 8, 2
    cases, t0 = 0, time.perf_counter()
    splits = sa_search.split_launches
    for size in (5, 8, 13, 19):
        query = pack_query(min(entries, key=lambda e: (abs(e.order - size),
                                                       e.name)))
        n1 = query.order
        n1r = round8(n1)
        q = pack_queries([query], n1r, dev)
        shape = (1, plan.nentries, r_seq, slots_per_restart(n1r), c_par)
        u = torch.from_numpy(r.random(shape, dtype=np.float32)).to(dev)
        u = rng.log_acc_slots(u, n1r).contiguous()
        host_u = u.cpu().numpy()
        for lorder in (True, False):
            scores, maps = sa_search(*q, plan, uniforms=u, c_par=c_par,
                                     r_seq=r_seq, lorder=lorder, lsoln=True)
            scores, maps = scores.cpu().numpy(), maps.cpu().numpy()
            for col, idx in enumerate(plan.index):
                if idx < 0:
                    continue
                score, bestmap = golden.search_entry(
                    query, pack_query(db_entries[idx]), lorder,
                    host_u[0, col])
                if (scores[0, col] != score
                        or not np.array_equal(maps[0, col, :n1], bestmap)
                        or (maps[0, col, n1:] != -1).any()):
                    raise AssertionError(
                        f"kernel != golden: n1 {n1}, LORDER {lorder}, "
                        f"entry {db_entries[idx].name} (order "
                        f"{db_entries[idx].order}): {scores[0, col]} vs "
                        f"{score}")
                cases += 1
    splits = sa_search.split_launches - splits
    say(f"phase11c kernel == golden.sa_chain per chain (c_par {c_par}, r_seq "
        f"{r_seq}, supplied uniforms, LSOLN; score and first maximal "
        f"chain's map, tolerance 0: bitwise): {cases} cases (query n1 5/8/"
        f"13/19 built, LORDER T/F, widths {[b.dim for b in db.buckets]} "
        f"with a built and a random entry each), {splits} split launches; "
        f"lockstep wall {time.perf_counter() - t0:.1f} s (host clock)")
    if cases != 4 * 2 * len(db_entries):
        raise AssertionError(f"{cases} lockstep cases")
    if not splits:
        raise AssertionError("no launch split its restarts")


def phase11d(tmp, qids, lsoln_out, card):
    """tools.tophits (10 bundles per query; the self-hit superimposes at
    rmsd < 0.001 A where its map is the identity) and tools.ssemap to
    HTML, on phase 11b's LSOLN output."""
    from cuda_satabsearch_tpu_torch.tools.ssemap import iter_ssemap_output

    pdb = os.path.join(tmp, "pdb")
    self_maps = {h.query: h.ssemap for h in iter_ssemap_output(
        io.StringIO(lsoln_out)) if h.query == h.name}
    walls, rmsds = [], []
    for qid in qids:
        hits_dir = os.path.join(tmp, f"hits_{qid}")
        _, err, wall = run_module(
            "cuda_satabsearch_tpu_torch.tools.tophits",
            [qid, hits_dir, "--query-pdb", os.path.join(pdb, f"{qid}.ent"),
             "--pdb-dir", pdb, "-n", "10"], stdin=lsoln_out)
        walls.append(wall)
        files = os.listdir(hits_dir)
        npml = sum(f.endswith(".pml") and not f.startswith("loadhits")
                   for f in files)
        if "wrote 10 hit bundle(s)" not in err or npml != 10:
            raise AssertionError(f"tophits {qid}: {npml} bundles; {err}")
        with open(os.path.join(hits_dir, f"{qid}_{qid.upper()}.pdb")) as fp:
            rmsd = float(re.search(r"rmsd ([0-9.]+) A", fp.readline()).group(1))
        smap = self_maps[qid]
        identity = smap == [(k, k) for k in range(1, len(smap) + 1)]
        rmsds.append((qid, rmsd, identity))
        if identity and rmsd >= 0.001:
            raise AssertionError(f"self-hit {qid} rmsd {rmsd} A")
    html, _, t_html = run_module("cuda_satabsearch_tpu_torch.tools.ssemap",
                                 [], stdin=lsoln_out)
    rows = html.count("<tr>") - 1
    nhits = len(list(iter_ssemap_output(io.StringIO(lsoln_out))))
    say(f"phase11d tophits -n 10 per query: 10 bundles each, wall "
        f"{' / '.join(f'{w:.2f}' for w in walls)} s (child process, host "
        f"clock); self-hit (query, rmsd A, map identity) {rmsds}; ssemap "
        f"HTML {rows} rows in {t_html:.2f} s; card {card}")
    if rows != nhits:
        raise AssertionError(f"{rows} HTML rows for {nhits} hits")


def phase11e(dev, out, card):
    """The SA kernel's rate per bucket width, each width's bucket holding
    4 waves of CTAs at r = 128; balance_report's per-shard prediction
    against large14291's shard on a 2-shard mesh of cuda:0."""
    from cuda_satabsearch_tpu_torch.io.pack import pack_database
    from cuda_satabsearch_tpu_torch.ops.balance import (RATE_M_IT_S,
                                                        balance_report)
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (
        make_plan, pack_queries, prepare_bucket)
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import (occupancy, prepare,
                                                          sa_search)
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    prepare(dev)
    query = read_query("d1ubia_.input")[0]
    q = pack_queries([query], 8, dev)
    kw = dict(seed=1234, tags=[0], c_par=128, r_seq=1, lorder=True,
              lsoln=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    r = np.random.default_rng(12)
    rates, cells = {}, []
    for d2 in WIDTHS:
        ctas = occupancy(d2, 8, 128, False)[0]
        n = 4 * sms * ctas
        lo, hi = width_range(d2)
        entries = [random_entry(r, int(r.integers(lo, hi + 1)), f"w{i}")
                   for i in range(n)]
        (bucket,) = pack_database(entries, buckets=(d2, 112) if d2 < 112
                                  else (112,)).buckets
        plan = make_plan([prepare_bucket(bucket, dev)])
        ms = cuda_ms(lambda: sa_search(*q, plan, **kw), 5)
        rates[d2] = n * 128 * 100 / (ms * 1e-3) / 1e6
        cells.append(f"d2 {d2}: {n} entries ({ctas} CTAs/SM) {ms:.4f} ms, "
                     f"{rates[d2]:.1f}")
        del plan, bucket, entries
    out["rates"] = rates
    say(f"phase11e SA kernel rate per bucket width, 8-SSE d1ubia_, r = 128 "
        f"(c_par 128), LSOLN off, 4 waves each (CUDA events, 5 reps; M "
        f"entry-it/s): {'; '.join(cells)}; card {card}")
    say("phase11e RATE_M_IT_S = {" + ", ".join(
        f"{d2}: {rates[d2]:.1f}" for d2 in WIDTHS) + "}")
    sess = SearchSession("<synthetic>", SessionConfig(
        maxstart=128, use_mesh=True, devices=[dev, dev]),
        entries=synthetic_entries(14291))
    shard = sess.device_db[0]
    measured = cuda_ms(lambda: sa_search(*q, shard, **kw), 10)
    for label, table in (("this run's rates", rates),
                         ("ops/balance.py's RATE_M_IT_S", RATE_M_IT_S)):
        rep = balance_report(sess.db, 2, rates=table)
        pred = rep["per_shard_ms"][0]
        say(f"phase11e large14291 on the mesh [cuda:0, cuda:0]: shard 0 "
            f"kernels {measured:.4f} ms (CUDA events, 10 reps), "
            f"balance_report with {label} {pred:.3f} ms per shard "
            f"(imbalance {rep['imbalance']}, naive split "
            f"{rep['naive_imbalance']:.4f}, padding "
            f"{rep['padding_overhead']:.4f}): relative error "
            f"{(pred - measured) / measured:+.4f}; card {card}")
        if rep["imbalance"] != 0.0 or not np.isfinite(pred):
            raise AssertionError(f"balance report {rep}")


def phase11f(dev, out, card):
    """graft_entry.entry() and dryrun_multichip on every visible card
    and on 2 shards; latency_budget's split by the program's spans."""
    from cuda_satabsearch_tpu_torch import graft_entry, latency_budget
    from cuda_satabsearch_tpu_torch.ops.engine import search_plan_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search

    fn, args = graft_entry.entry()
    before = sa_search.launches
    scores, maps = fn(*args)
    torch.cuda.synchronize()
    launches = sa_search.launches - before
    ref = search_plan_plain(*args, seed=graft_entry.SEED, tags=[0],
                            c_par=16, r_seq=1, lorder=True, lsoln=True)
    err = compare((scores, maps), ref)
    say(f"phase11f graft_entry.entry() on {scores.device}: scores "
        f"{tuple(scores.shape)}, maps {tuple(maps.shape)}, {launches} SA "
        f"launches, == plain version max |diff| {err} (tolerance 0)")
    if err or launches < 1:
        raise AssertionError("graft_entry.entry() failed")
    for n in (torch.cuda.device_count(), 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            graft_entry.dryrun_multichip(n)
        for line in buf.getvalue().splitlines():
            say(f"phase11f {line}")
    b = latency_budget.budget()
    out["latency"] = b
    say(f"phase11f latency budget (586 entries, d1ubia_, r = 128, median "
        f"self time per span over {b['reps']} queries): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in b["self_ms"].items())
        + f"; whole query {b['query_ms']:.4f} ms; card {card}")


# the root bench.py's JSON keys at its defaults
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "per_query_m_it_s",
              "per_query_vs_baseline", "large14291_m_it_s",
              "large14291_vs_baseline", "bigquery_r4096_m_it_s",
              "bigquery_r4096_vs_baseline"}
BENCH_LAUNCHES = re.compile(r"kernel launches in this run: SA kernel (\d+), "
                            r"start-up kernel (\d+)")


def phase12a(dev, out, card):
    """``python -m cuda_satabsearch_tpu_torch.bench`` at its defaults (all
    three shapes) in a child process: one JSON line with the root
    bench's keys, the reference's top 3 on the 586db per-query search,
    both kernels launched in the run."""
    stdout, err, wall = run_module("cuda_satabsearch_tpu_torch.bench", [],
                                   timeout=900)
    lines = stdout.strip().splitlines()
    res = json.loads(lines[-1])
    top = re.search(r"^# \[586db\] top hits: (\[.*\])$", err, re.M)
    top = ast.literal_eval(top.group(1)) if top else []
    launches = BENCH_LAUNCHES.search(err)
    sa, warm = (int(g) for g in launches.groups()) if launches else (0, 0)
    out["bench_launches"] = (sa, warm)
    for ln in err.splitlines():
        if re.match(r"# \[\S+\] (per-query|sustained|top hits)", ln) or (
                ln.startswith(("# card", "# db", "# large db", "# big q"))):
            say(f"phase12a {ln}")
    say(f"phase12a bench JSON values: {json.dumps(res)}; child process "
        f"{wall:.1f} s; card {card}")
    if len(lines) != 1 or set(res) != BENCH_KEYS:
        raise AssertionError(f"bench stdout {lines}: keys {sorted(res)}")
    if {n for n, _ in top} != TOP3:
        raise AssertionError(f"586db top 3 {top} != {sorted(TOP3)}")
    if not sa or not warm:
        raise AssertionError(f"bench launches: SA {sa}, start-up {warm}")
    if not all(np.isfinite(v) and v > 0 for k, v in res.items()
               if k not in ("metric", "unit")):
        raise AssertionError(f"bench values {res}")


def phase12b(dev, out, card):
    """``bench --paritycheck --out``: kernel == plain engine bitwise on
    n1 8/19/101 x LORDER, both streams, and a tiled batch; PASS in its
    artifact, the root PARITY.json untouched."""
    jax_parity = os.path.join(ROOT, "PARITY.json")
    with open(jax_parity, "rb") as fp:
        before = fp.read()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "parity.json")
        stdout, err, wall = run_module("cuda_satabsearch_tpu_torch.bench",
                                       ["--paritycheck", "--out", path])
        with open(path) as fp:
            art = json.load(fp)
    last = json.loads(stdout.strip().splitlines()[-1])
    oks = [ln for ln in err.splitlines() if ln.startswith("PARITY OK")]
    for ln in oks[-1:]:
        say(f"phase12b {ln}")
    say(f"phase12b bench --paritycheck: {art['result']} ({len(oks)} of "
        f"{art['checks']} checks OK; {art['gate']}); {art['seconds']} s in "
        f"the gate, child process {wall:.1f} s; last line {json.dumps(last)}"
        f"; card {art['card']}")
    with open(jax_parity, "rb") as fp:
        if fp.read() != before:
            raise AssertionError("the root PARITY.json was changed")
    if art["result"] != "PASS" or art["failed"] or last != {
            "metric": "hw_bitwise_parity", "value": 1, "unit": "pass",
            "vs_baseline": 1.0}:
        raise AssertionError(f"paritycheck: {art}")


def phase12c(dev, out, card):
    """65,536 copies of an 8-SSE query in one ``search_many`` against a
    one-entry DB, LSOLN off (over the 65,535 queries one launch's grid
    takes): queries 0, 1 and 65,535 == single searches at their tags."""
    from cuda_satabsearch_tpu_torch.io.pack import pack_query
    from cuda_satabsearch_tpu_torch.ops import kernel_search
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    # r = 8 against a 30-SSE entry: the score varies with the query's tag
    # (at r = 128 every tag reaches the same maximum)
    r = np.random.default_rng(65536)
    sess = SearchSession("<one entry>", SessionConfig(
        maxstart=8, device=str(dev)), entries=[random_entry(r, 30, "one")])
    query = pack_query(random_entry(r, 8, "q8"))
    K = 65536
    sa_search.launches = 0
    t0 = time.perf_counter()
    res = sess.search_many([query] * K, lsoln=False)
    wall = time.perf_counter() - t0
    launches = sa_search.launches
    out.setdefault("launches_by_path", {})["phase12c 65536 queries"] = launches
    bound = 2 * -(-K // kernel_search.K_TILE)
    sample = (0, 1, 63, 64, K - 1)  # first, tile edges, last
    diffs = [int(np.abs(sess.search(query, lsoln=False, query_tag=k).scores
                        - res[k].scores).max()) for k in sample]
    scores = np.array([x.scores[0] for x in res])
    say(f"phase12c {K} queries in one search_many vs a 1-entry DB (r=8, "
        f"LSOLN off): {launches} SA launches (K_TILE "
        f"{kernel_search.K_TILE}, at most {bound}), {wall:.3f} s wall; "
        f"queries {sample} == single searches: max |diff| {diffs} "
        f"(tolerance 0); {len(np.unique(scores))} distinct scores "
        f"{scores.min()}-{scores.max()}; card {card}")
    if not 1 <= launches <= bound:
        raise AssertionError(f"{launches} SA launches for {K} queries")
    if any(diffs) or len(res) != K or len(np.unique(scores)) < 2:
        raise AssertionError("batched and single searches differ")


def phase12d(dev, out, card):
    """The CLI on multiquery.input in this process: output == the JAX
    package's committed XLA-engine output (header aside), 6 SA launches
    and one drain after all of them."""
    from cuda_satabsearch_tpu_torch import cli
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.ops.search import Searcher

    with open(os.path.join(FIXTURES, "multiquery.input")) as fp:
        text = fp.read()
    drains, drain = [], Searcher.drain

    def recorded(self, *a, **k):
        drains.append(sa_search.launches)
        return drain(self, *a, **k)

    stdout, stderr = io.StringIO(), io.StringIO()
    old_stdin, old_cwd = sys.stdin, os.getcwd()
    sa_search.launches = 0
    try:
        Searcher.drain = recorded
        sys.stdin = io.StringIO(text)
        os.chdir(FIXTURES)  # the input names its DB relative to it
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = cli.main(["-r", "128"])
    finally:
        Searcher.drain = drain
        sys.stdin = old_stdin
        os.chdir(old_cwd)
    launches = sa_search.launches
    out.setdefault("launches_by_path", {})["phase12d CLI multiquery"] = (
        launches)
    with open(JAX_XLA_OUT) as fp:
        same = HEADER.sub("", stdout.getvalue()) == HEADER.sub("", fp.read())
    search_ms = re.search(r"search time ([0-9.]+) ms", stderr.getvalue())
    say(f"phase12d CLI -r 128 on multiquery.input in this process: exit {rc}"
        f", output == the JAX package's committed XLA-engine output (header "
        f"aside): {same}; {launches} SA launches; drains {len(drains)}, "
        f"after {drains} launches; search "
        f"{search_ms.group(1) if search_ms else '?'} ms; card {card}")
    if rc != 0 or not same:
        raise AssertionError(f"CLI exit {rc}, output same: {same}")
    if launches != 6 or drains != [6]:
        raise AssertionError(f"{launches} launches, drains after {drains}")


def phase12e(dev, out, card):
    """K_TILE A/B in one process: the bench's 586db sustained stream (384
    copies of d1ubia_, r = 128) in tiles of 64, 128, 256 and in one
    tile of 384, interleaved, best of 5 search_many walls each turn."""
    from cuda_satabsearch_tpu_torch.ops import kernel_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    sess = SearchSession(DB586, SessionConfig(maxstart=128, device=str(dev)))
    queries = read_query("d1ubia_.input") * 384
    it = sess.nentries * 128 * 100 * len(queries)
    walls, k_tile = {}, kernel_search.K_TILE
    try:
        for tile in (64, 128, 256, 384, 384, 256, 128, 64):
            kernel_search.K_TILE = tile
            sess.search_many(queries)
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                sess.search_many(queries)  # ends in its drain
                best = min(best, time.perf_counter() - t0)
            walls.setdefault(tile, []).append(best * 1e3)
    finally:
        kernel_search.K_TILE = k_tile
    cells = "; ".join(
        f"{t}: {' / '.join(f'{w:.3f}' for w in ws)} ms "
        f"({it / min(ws) / 1e3:.1f} M it/s)" for t, ws in walls.items())
    slower = min(walls[64]) / min(walls[384]) - 1
    say(f"phase12e K_TILE A/B, 586db sustained stream of 384 queries, r=128 "
        f"(search_many wall, best of 5 per turn, turns interleaved): {cells}"
        f"; tiles of 64 against one tile of 384: {slower:+.4f} (the module's "
        f"K_TILE: {k_tile}); card {card}")


def report_occupancy(dev):
    """Each launch class's CTAs per SM at its widest bucket (d2 32 and
    112), n1r 8, c_par 128, LSOLN on, and the shared memory per CTA there
    against the kernel's earlier layout of int8 planes."""
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import (load_library,
                                                          occupancy, prepare)

    prepare(dev)
    lib = load_library().lib
    for cls, d2 in (("narrow", 32), ("wide", 112)):
        blocks, regs, local = occupancy(d2, 8, 128, True)
        sblocks, sregs, slocal = occupancy(d2, 8, 128, True, split=True)
        smem = lib.sa_search_smem_bytes(8, d2, 128, 1)
        say(f"  {cls} class at d2 {d2}, n1r 8, c_par 128, LSOLN: {blocks} "
            f"CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
            f"{regs} registers, {local} local bytes per thread, {smem} B "
            f"of shared memory per CTA; split: {sblocks} CTAs per SM, "
            f"{sregs} registers, {slocal} local bytes")
    # the earlier layout: f32 distances, int8 codes and types, int8 map,
    # reverse and best planes, int32 reduction, each region 16-byte
    # aligned
    a16 = lambda x: -(-x // 16) * 16
    old = sum(a16(x) for x in (4 * 8 * 8, 4 * 112 * 112, 8 * 8, 112 * 112,
                               8, 112, 8 * 128, 112 * 128, 8 * 128,
                               4 * 130))
    say(f"  shared memory per CTA at n1r 8, d2 112, LSOLN, c_par 128: "
        f"{lib.sa_search_smem_bytes(8, 112, 128, 1)} B (int8-plane layout: "
        f"{old} B)")


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
        if "registers" in line or "spill" in line or "Function prop" in line:
            say(f"  ptxas: {line.strip()}")
    report_occupancy(dev)

    out, failed = {}, []
    errs = {}  # phase -> max |diff| against the plain version
    phases = (("phase0", phase0), ("phase1", phase1), ("phase2", phase2),
              ("phase3", phase3), ("phase4", phase4),
              ("phase5", lambda d, o: phase5(d, o, card)),
              ("phase6", phase6),
              ("phase7", lambda d, o: phase7(d, o, card)),
              ("phase8", lambda d, o: phase8(d, o, card)),
              ("phase9", lambda d, o: phase9(d, o, card)),
              ("phase10", lambda d, o: phase10(d, o, card)),
              ("phase11", lambda d, o: phase11(d, o, card)),
              ("phase11e", lambda d, o: phase11e(d, o, card)),
              ("phase11f", lambda d, o: phase11f(d, o, card)),
              ("phase12a", lambda d, o: phase12a(d, o, card)),
              ("phase12b", lambda d, o: phase12b(d, o, card)),
              ("phase12c", lambda d, o: phase12c(d, o, card)),
              ("phase12d", lambda d, o: phase12d(d, o, card)),
              ("phase12e", lambda d, o: phase12e(d, o, card)))
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
    share = lambda b, t: None if b is None or not t else b / t
    # start-up kernel: f32[8, 128] read once and written once
    warm_bound = 2 * 4 * 8 * 128 / HBM_BYTES_S * 1e3
    bench_sa, bench_warm = out.get("bench_launches", (None, None))
    say(json.dumps({"kernels": [{
        "name": "sa_search", "route": "cuda",
        "source": "cuda_satabsearch_tpu_torch/csrc/sa_search.cu",
        "replaces": "cuda_satabsearch_tpu/ops/pallas_sa2.py:535",
        "launches": out.get("launches"),
        "launches_by_path": {"phase3 CLI d1ubia_": out.get("launches"),
                             "phase12a bench": bench_sa,
                             **out.get("launches_by_path", {})},
        "launches_per_query": out.get("launches"),
        "max_abs_err": max(sa_errs) if sa_errs else None,
        "ms": out.get("ms"), "plain_ms": out.get("plain_ms"),
        "bound_ms": out.get("bound_ms"), "bound_by": out.get("bound_by"),
        "bound_share": share(out.get("bound_ms"), out.get("ms")),
        "library_ms": None}, {
        "name": "add_one", "route": "cuda",
        "source": "cuda_satabsearch_tpu_torch/csrc/warmup.cu",
        "replaces": "cuda_satabsearch_tpu/core/warmup.py:51",
        "launches": out.get("warm_launches"),
        "launches_by_path": {"phase3 CLI d1ubia_": out.get("warm_launches"),
                             "phase12a bench": bench_warm},
        "launches_per_query": 0,
        "max_abs_err": errs.get("phase0"),
        "ms": out.get("warm_ms"), "plain_ms": out.get("warm_plain_ms"),
        "bound_ms": warm_bound, "bound_by": "bytes",
        "bound_share": share(warm_bound, out.get("warm_ms")),
        "library_ms": out.get("warm_plain_ms")}, {
        # a helper of sa_search: its table of exact logs, once per device
        "name": "sa_ln_grid", "route": "cuda",
        "source": "cuda_satabsearch_tpu_torch/csrc/sa_search.cu",
        "replaces": None,
        "launches": out.get("ln_grid_launches"),
        "launches_by_path": {"sa_kernel.prepare, per device":
                             out.get("ln_grid_launches")},
        "launches_per_query": 0,
        "max_abs_err": out.get("ln_grid_err"),
        "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
        "bound_share": None, "library_ms": None}]}))
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
