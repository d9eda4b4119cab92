"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernel library (the SA search kernel and the start-up
kernel) from cuda_satabsearch_tpu_torch/csrc/ with nvcc, holds each
kernel against its plain PyTorch version on the card, drives the port's
main path (the ``torchsatabsearch`` CLI) on the 586-entry fixture DB,
and times a 14291-entry ASTRAL-like synthetic DB.  Phases:

0. start-up kernel vs x + 1 on f32[8, 128]: bitwise, and both timed;
1. SA kernel vs plain engine on a supplied stream: bitwise scores and maps;
2. kernel's in-kernel threefry stream vs the plain engine on the stream
   ops/rng.py makes on the card: bitwise;
3. CLI main path, d1ubia_ query vs the 586-entry DB at r=128: the
   reference's top 3, scores equal to the plain engine's on the card,
   and both kernels' launch counters show the path ran through them;
4. multiquery.input (8/13/101-SSE queries): batched search_many equals
   per-query search, bitwise;
5. timings: kernel vs plain on the 586-entry DB, and the 14291-entry
   synthetic DB per query and batched.

Prints one line per phase, then a JSON line with the kernels' numbers,
then ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
without that line when there is no CUDA device or any phase fails.
"""

import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TOP3 = {"d1c3ta_", "d2faza1", "d1uela_"}  # README_example_usage.txt:92-111


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
    combinations of LORDER, LSOLN, c_par, r_seq and K (all 32 used)."""
    from cuda_satabsearch_tpu_torch.io.pack import pack_database, pack_query
    from cuda_satabsearch_tpu_torch.ops.common import round8
    from cuda_satabsearch_tpu_torch.ops.kernel_search import (
        pack_queries, prepare_bucket)

    rng = np.random.default_rng(2024)
    combos = list(itertools.product((True, False), (True, False), (128, 100),
                                    (1, 2), (1, 3)))
    shapes = list(itertools.product((8, 16, 48, 112), (5, 8, 13, 19, 101)))
    pairs = zip(shapes * 2, combos + combos[:8])
    for ci, ((d2, n1), combo) in enumerate(pairs):
        lorder, lsoln, c_par, r_seq, K = combo
        n1r = round8(n1)
        orders = [n1, max(n1r - 7, 2), n1r][:K]
        queries = [pack_query(random_entry(rng, o, f"q{k}"))
                   for k, o in enumerate(orders)]
        lo = max(2, d2 - 7) if d2 > 8 else 2
        entries = [random_entry(rng, int(o), f"e{i}")
                   for i, o in enumerate(rng.integers(lo, d2 + 1, size=5))]
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


def phase0(dev, out):
    from cuda_satabsearch_tpu_torch.core.warmup import SHAPE, add_one

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        SHAPE).astype(np.float32)).to(dev)
    got = add_one(x)
    torch.cuda.synchronize()
    err = (got - (x + 1.0)).abs().max().item()
    # plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: x + 1.0, 200)
    k1 = cuda_ms(lambda: add_one(x), 200)
    k2 = cuda_ms(lambda: add_one(x), 200)
    p2 = cuda_ms(lambda: x + 1.0, 200)
    out["warm_ms"], out["warm_plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"phase0 start-up kernel == x + 1 on f32{list(SHAPE)} on the card: "
        f"max |diff| {err} (tolerance 0: bitwise); kernel {k1:.5f} / "
        f"{k2:.5f} ms, plain {p1:.5f} / {p2:.5f} ms per call (CUDA events)")
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

    dbfile = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        body = fp.read().splitlines(keepends=True)[2:]
    stdin = io.StringIO(f"{dbfile}\nT T F\n" + "".join(body))
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
    plain = SearchSession(dbfile, SessionConfig(maxstart=128, backend="torch",
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

    dbfile = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
    queries = read_query("multiquery.input")
    sess = SearchSession(dbfile, SessionConfig(maxstart=128, backend="cuda",
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
    keys = [rng.entry_keys(1234, [0], b.index, device=dev)
            for b in sess.device_db]
    kw = dict(c_par=128, r_seq=1, lorder=True, lsoln=False)

    def run():
        for b, k in zip(sess.device_db, keys):
            fn(*q, b.types, b.tab, b.dmat, b.n2, keys=k, **kw)

    return cuda_ms(run, reps)


def phase5(dev, out, card):
    from cuda_satabsearch_tpu_torch.ops.engine import search_plain
    from cuda_satabsearch_tpu_torch.ops.sa_kernel import sa_search
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    query = read_query("d1ubia_.input")[0]
    dbfile = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
    sess = SearchSession(dbfile, SessionConfig(maxstart=128, device=str(dev)))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
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
    lib = load_library()
    say(f"kernel built in {lib.build_s:.1f} s -> "
        f"{os.path.relpath(lib.path, ROOT)}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    out, failed = {}, []
    errs = {}  # phase -> max |diff| against the plain version
    for name, fn in (("phase0", phase0), ("phase1", phase1),
                     ("phase2", phase2), ("phase3", phase3),
                     ("phase4", phase4),
                     ("phase5", lambda d, o: phase5(d, o, card))):
        try:
            err = fn(dev, out)
            if err is not None:
                errs[name] = err
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            say(f"{name} FAILED")
            failed.append(name)
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
