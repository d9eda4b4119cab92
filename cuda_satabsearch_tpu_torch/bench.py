"""Benchmark of the port against the reference's recorded GPU baselines,
all shapes by default: the counterpart of the root ``bench.py`` (the JAX
package's runner, which imports jax and stays its own).

  586db          586-entry DB (tableauxdistmatrixdb.small.ascii),
                 8-SSE ubiquitin query, r=128, 100 iterations.
                 Baseline: NVIDIA A100-PCIE-40GB, 1264.7 M it/s
                 (README_example_usage.txt:84-85; BASELINE.md).
  large14291     synthetic 14291-entry ASTRAL-like DB
                 (synthetic.astral_entries, the root bench's generator),
                 same query.  Baseline: A100 full-ASTRAL, 1903.2 M it/s
                 (README_example_usage.txt:241-242).
  bigquery       19-SSE d2phlb1 query at r=4096 on the 586-entry DB.
                 Baseline: Tesla M2070, 145.3 M it/s
                 (old/nvcc_src_cuda5/gpucudaSaTabsearch_fermi.e1462444).

    python -m cuda_satabsearch_tpu_torch.bench [--restarts N]
        [--backend {auto,cuda,torch}] [--large N] [--skip-large]
        [--skip-big-query] [-c]
    python -m cuda_satabsearch_tpu_torch.bench --paritycheck --out PATH

Searches on the card with the CUDA kernel by default; ``-c`` runs the
plain engine on the CPU.  Without a card and without ``-c`` it exits 1.
Prints ONE JSON line on stdout with the root bench's keys: the headline
is the 586db SUSTAINED throughput (a stream of queries in one
``search_many``, launched whole before its one drain), with the
per-query, large-DB and big-query numbers as extra fields:

  {"metric": "sa_search_throughput_586db_8sse_r128_sustained",
   "value": N, "unit": "M it/s", "vs_baseline": N,
   "per_query_m_it_s": ..., "per_query_vs_baseline": ...,
   "large14291_m_it_s": ..., "large14291_vs_baseline": ...,
   "bigquery_r4096_m_it_s": ..., "bigquery_r4096_vs_baseline": ...}

stderr carries the root bench's ``#`` lines and, last, the card's name
and power limit (nvidia-smi) with the run's kernel launch counts.

``--paritycheck`` is the counterpart of scripts/hw_paritycheck.py on the
card: the SA kernel against the plain engine (ops/engine.py), bitwise on
scores and LSOLN maps, for query orders 8, 19 and 101 x LORDER T/F over
buckets of widths 8-112 in both launch classes, on a supplied stream
and on the stream the kernel draws itself; then a stream of mixed
orders in one ``search_many``, in query tiles of 3, against one query
at a time.  It writes its artifact only to ``--out`` (never to the root
PARITY.json, the JAX package's) and prints the root bench's parity line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from .core.warmup import add_one
from .io.pack import pack_database, pack_query
from .io.parser import parse_search_input
from .ops import kernel_search
from .ops import rng as prng
from .ops.common import round8, slots_per_restart
from .ops.engine import search_plan_plain
from .ops.kernel_search import make_plan, pack_queries, prepare_bucket
from .ops.sa_kernel import sa_search
from .ops.search import resolve_backend
from .session import SearchSession, SessionConfig
from .synthetic import astral_entries, random_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
DB586 = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
JAX_PARITY = os.path.join(REPO, "PARITY.json")  # the JAX package's artifact
BASELINE_M_IT_S = 1264.7  # A100, same workload (README_example_usage.txt:85)
BASELINE_LARGE = 1903.2  # A100, 14291-entry ASTRAL (README_example:241-242)
BASELINE_BIGQ = 145.3  # M2070, 19-SSE r=4096 small pass (fermi.e1462444)
REPEATS = 5
# queries of each shape's sustained stream, and the big query's restarts
NQ_586, NQ_LARGE, NQ_BIGQ = 384, 64, 16
BIGQ_RESTARTS = 4096
PARITY_SEED, PARITY_TAG = 1234, 5  # scripts/hw_paritycheck.py's stream
PARITY_ORDERS = (8, 19, 101)
PARITY_K_TILE = 3  # several tiles in each group of the batched check


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    if res.returncode != 0 or not res.stdout.strip():
        return f"nvidia-smi failed: {res.stderr.strip()}"
    return res.stdout.strip().splitlines()[0]


def read_query(name: str):
    with open(os.path.join(FIXTURES, name)) as fp:
        return pack_query(parse_search_input(fp).queries[0])


def run_search(session, query, restarts, label, baseline, nq=NQ_586):
    """(per_query, sustained) M it/s for one workload shape (the root
    bench's ``run_search``).

    per_query is the best of REPEATS single searches, each ending in its
    drain; sustained is the best of 3 ``search_many`` calls of ``nq``
    copies of the query (launched whole, then drained once), after one
    untimed call."""
    t0 = time.perf_counter()
    result = session.search(query, lorder=True, query_tag=0)
    print(f"# [{label}] warm-up (incl. compile): "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    best = float("inf")
    for rep in range(REPEATS):
        t0 = time.perf_counter()
        result = session.search(query, lorder=True, query_tag=rep)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(f"# [{label}] rep {rep}: {dt * 1000:.1f} ms", file=sys.stderr)
    iters = session.nentries * restarts * session.config.params.maxiter
    m_it_s = iters / best / 1e6
    top = sorted(zip(result.scores, result.names), reverse=True)[:3]
    print(f"# [{label}] top hits: {[(n, int(s)) for s, n in top]}",
          file=sys.stderr)
    print(f"# [{label}] per-query {m_it_s:.1f} M it/s "
          f"({m_it_s / baseline:.3f}x of baseline)", file=sys.stderr)

    session.search_many([query] * nq)  # warm the stream's path
    best_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        session.search_many([query] * nq)
        best_s = min(best_s, time.perf_counter() - t0)
    sustained = iters * nq / best_s / 1e6
    print(f"# [{label}] sustained ({nq} pipelined queries): "
          f"{sustained:.1f} M it/s ({sustained / baseline:.3f}x)",
          file=sys.stderr)
    return m_it_s, sustained


def bench(args) -> dict:
    """The three shapes: the JSON line's object."""
    config = dict(backend=args.backend, device="cpu" if args.cpu else None)
    resolve_backend(**config)  # no card, no -c: fail before any work
    query = read_query("d1ubia_.input")
    session = SearchSession(DB586, SessionConfig(maxstart=args.restarts,
                                                 **config))
    print(f"# db: {session.nentries} entries, query: {query.name} "
          f"({query.order} SSEs), restarts: {args.restarts}, "
          f"backend: {args.backend}", file=sys.stderr)
    per_query, sustained = run_search(session, query, args.restarts,
                                      "586db", BASELINE_M_IT_S, nq=NQ_586)
    out = {
        "metric": "sa_search_throughput_586db_8sse_r128_sustained",
        "value": round(sustained, 2),
        "unit": "M it/s",
        "vs_baseline": round(sustained / BASELINE_M_IT_S, 4),
        "per_query_m_it_s": round(per_query, 2),
        "per_query_vs_baseline": round(per_query / BASELINE_M_IT_S, 4),
    }

    if args.large and not args.skip_large:
        big = SearchSession("<synthetic>", SessionConfig(
            maxstart=args.restarts, **config),
            entries=astral_entries(args.large))
        print(f"# large db: {big.nentries} entries (ASTRAL-like mix)",
              file=sys.stderr)
        _, lsust = run_search(big, query, args.restarts,
                              f"large{args.large}", BASELINE_LARGE,
                              nq=NQ_LARGE)
        out[f"large{args.large}_m_it_s"] = round(lsust, 2)
        out[f"large{args.large}_vs_baseline"] = round(
            lsust / BASELINE_LARGE, 4)

    if not args.skip_big_query:
        bq = read_query("d2phlb1.input")
        sess4k = SearchSession(DB586, SessionConfig(maxstart=BIGQ_RESTARTS,
                                                    **config))
        print(f"# big query: {bq.name} ({bq.order} SSEs), "
              f"r={BIGQ_RESTARTS}", file=sys.stderr)
        _, qsust = run_search(sess4k, bq, BIGQ_RESTARTS, "d2phlb1_r4096",
                              BASELINE_BIGQ, nq=NQ_BIGQ)
        out["bigquery_r4096_m_it_s"] = round(qsust, 2)
        out["bigquery_r4096_vs_baseline"] = round(qsust / BASELINE_BIGQ, 4)
    return out


def parity_checks(device) -> list[tuple[str, bool]]:
    """[(what, passed)] of the parity gate on ``device`` (a CUDA device;
    on the CPU the kernel's wrapper runs the plain version itself, so
    only the gate's own plumbing is checked there).  Prints a PARITY
    line per check on stderr."""
    dev = torch.device(device)
    r = np.random.default_rng(99)
    # scripts/hw_paritycheck.py's DB: 21 entries of 4-16 SSEs and three
    # of 40, 75 and 101, here in the default buckets (8/16 narrow,
    # 48/80/112 wide: both launch classes)
    sizes = list(r.integers(4, 17, size=21)) + [40, 75, 101]
    entries = [random_entry(r, int(n), f"e{i:03d}")
               for i, n in enumerate(sizes)]
    db = pack_database(entries)
    plan = make_plan([prepare_bucket(b, dev) for b in db.buckets])
    widths = [b.dim for b in plan.buckets]
    c_par, r_seq = 32, 2
    kw = dict(c_par=c_par, r_seq=r_seq, lsoln=True)
    checks = []

    def record(what, ok):
        print(f"PARITY {'OK  ' if ok else 'FAIL'} {what}", file=sys.stderr)
        checks.append((what, ok))

    for n1 in PARITY_ORDERS:
        query = pack_query(random_entry(r, n1, "query"))
        n1r = round8(n1)
        q = pack_queries([query], n1r, dev)
        keys = prng.entry_keys(PARITY_SEED, [PARITY_TAG], plan.index,
                               device=dev)
        u = prng.make_uniforms(keys, r_seq, slots_per_restart(n1r), c_par,
                               n1r).contiguous()
        for lorder in (True, False):
            for mode, stream in (
                    ("supplied", dict(uniforms=u)),
                    ("in-kernel", dict(seed=PARITY_SEED,
                                       tags=[PARITY_TAG]))):
                got = sa_search(*q, plan, lorder=lorder, **stream, **kw)
                ref = search_plan_plain(*q, plan, lorder=lorder, **stream,
                                        **kw)
                record(f"n1={n1:3d} lorder={int(lorder)} {mode} stream: "
                       f"{plan.nentries} entries (widths {widths}), scores "
                       f"+ maps", all(torch.equal(x.cpu(), y.cpu())
                                      for x, y in zip(got, ref)))

    # a mixed-order stream in one search_many, in tiles of
    # PARITY_K_TILE queries, against one query at a time
    orders = (5, 8, 7, 3, 6, 8, 4, 2, 13, 16, 9, 19)
    queries = [pack_query(random_entry(r, o, f"b{i}"))
               for i, o in enumerate(orders)]
    sess = SearchSession("<parity>", SessionConfig(
        maxstart=c_par * r_seq, c_max=c_par, seed=PARITY_SEED,
        device=str(dev)), entries=entries)
    k_tile, kernel_search.K_TILE = kernel_search.K_TILE, PARITY_K_TILE
    try:
        before = sa_search.launches
        batched = sess.search_many(queries, lsoln=True)
        launches = sa_search.launches - before
    finally:
        kernel_search.K_TILE = k_tile
    groups = Counter(round8(q.order) for q in queries)
    ntiles = sum(-(-k // PARITY_K_TILE) for k in groups.values())
    expect = (ntiles * len(sess.device_db[0].classes)
              if sess.backend == "cuda" else 0)
    for tag, (q, b) in enumerate(zip(queries, batched)):
        one = sess.search(q, lsoln=True, query_tag=tag)
        record(f"batched q{tag} (n1={q.order}) == one query at a time",
               np.array_equal(b.scores, one.scores)
               and np.array_equal(b.ssemaps, one.ssemaps))
    record(f"batched stream: {len(queries)} queries in {len(groups)} round8 "
           f"groups, {ntiles} tiles of <= {PARITY_K_TILE}: {launches} SA "
           f"launches (expected {expect})", launches == expect)
    return checks


def paritycheck(args) -> int:
    if not args.out:
        raise ValueError("--paritycheck writes its artifact to --out PATH")
    out = os.path.abspath(args.out)
    if os.path.realpath(out) == os.path.realpath(JAX_PARITY):
        raise ValueError(f"--out {out}: PARITY.json is the JAX package's "
                         f"artifact; write elsewhere")
    if args.cpu:
        raise ValueError("--paritycheck holds the CUDA kernel against the "
                         "plain engine: it runs on a card, not with -c")
    _, device = resolve_backend("cuda")
    t0 = time.perf_counter()
    checks = parity_checks(device)
    failed = [what for what, ok in checks if not ok]
    artifact = {
        "gate": "SA kernel vs plain engine bitwise (scores+maps), n1 in "
                "{8,19,101} x lorder, supplied and in-kernel streams, "
                "bucket widths 8-112 in both launch classes; batched "
                f"search_many in tiles of {PARITY_K_TILE} vs one query at "
                "a time",
        "result": "FAIL" if failed else "PASS",
        "backend": "cuda",
        "device": torch.cuda.get_device_name(device),
        "card": card_line(),
        "checks": len(checks),
        "failed": failed,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fp:
        json.dump(artifact, fp, indent=1)
        fp.write("\n")
    if failed:
        print(f"paritycheck: {len(failed)} failing checks", file=sys.stderr)
        return 1
    print(f"paritycheck: all {len(checks)} checks bitwise equal",
          file=sys.stderr)
    print(json.dumps({"metric": "hw_bitwise_parity", "value": 1,
                      "unit": "pass", "vs_baseline": 1.0}))
    return 0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.bench",
        description="SA search throughput against the reference's GPU "
                    "baselines (three shapes), or the card's parity gate")
    ap.add_argument("--restarts", type=int, default=128)
    ap.add_argument("--backend", choices=("auto", "cuda", "torch"),
                    default="auto",
                    help="SA search: the CUDA kernel, or the plain PyTorch "
                         "engine (auto: the kernel, or with -c the plain "
                         "engine)")
    ap.add_argument("--large", type=int, default=14291,
                    help="synthetic large-DB entry count (default 14291, "
                         "the reference's full-ASTRAL size)")
    ap.add_argument("--skip-large", action="store_true",
                    help="headline 586db shape only")
    ap.add_argument("--big-query", action="store_true",
                    help=argparse.SUPPRESS)  # the root bench's; the default
    ap.add_argument("--skip-big-query", action="store_true",
                    help="skip the 19-SSE r=4096 shape")
    ap.add_argument("--paritycheck", action="store_true",
                    help="run the card's bitwise parity gate and write its "
                         "artifact to --out")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="the parity gate's artifact (never PARITY.json)")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run the plain engine on the CPU")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        if args.paritycheck:
            return paritycheck(args)
        out = bench(args)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    card = ("none (-c: the plain engine on the CPU)" if args.cpu
            else card_line())
    print(f"# card: {card}; kernel launches in this run: SA kernel "
          f"{sa_search.launches}, start-up kernel {add_one.launches}",
          file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
