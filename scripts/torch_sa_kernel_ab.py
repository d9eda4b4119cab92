"""Variants of the port's SA kernel (cuda_satabsearch_tpu_torch/csrc/
sa_search.cu), timed in turns in one process on one NVIDIA GPU.

    python3 scripts/torch_sa_kernel_ab.py
    python3 scripts/torch_sa_kernel_ab.py --lanes
    python3 scripts/torch_sa_kernel_ab.py --groups [SEED]
    python3 scripts/torch_sa_kernel_ab.py --full-card [SEED]

Each variant is the kernel's source with one part rewritten, built with
the port's nvcc flags into cuda_satabsearch_tpu_torch/_build/variants/
(one nvcc per variant, all at once) and run through the port's own
wrapper.  Two groups:

* design variants, which must stay bitwise equal to the kernel (the
  script checks it): ``no_ahead`` draws a move's uniforms in that move
  instead of one move ahead; ``ahead_nobranch`` draws ahead without the
  branch on the last move; ``popc_pick`` picks the (rpick+1)-th
  candidate with a popc binary search instead of ``__fns``;
* knock-outs, which give other results and are timed only, to see where
  a move's time goes: ``knock_log`` decides the Metropolis test with
  ``__logf(u)`` alone instead of the screened float32 test and its
  double-precision log (``LOG_KNOCK``), ``knock_rng`` replaces threefry
  by one multiply, ``knock_delta`` skips the O(n1) delta loop,
  ``knock_all`` does all three.

Times (CUDA events) on the 586-entry fixture DB with the d1ubia_ query
at r = 128 (the full plan, and the plan of the one 80-wide entry alone:
one CTA, the latency of one chain) and the d2phlb1 query at r = 4096,
in the order base, variants..., variants reversed, base.

``--lanes`` times the kernel as it is at each number of lanes per chain
(``sa_kernel.LANES``; ``sa_kernel.chain_lanes`` stubbed to give it):
one 586-entry query at r = 128, LSOLN on, in-kernel draws, against the
launch pair (narrow G 1, 2 x wide G 1, 2, 4) and against each
launch class alone (every G), for a query of 16 and one of 56 padded
SSEs; every G equals G = 1 bitwise (scores and maps).  Each instantiation's
CTAs per SM, registers and local bytes, and the rule's own choice, are
printed beside the times (CUDA events, 50 launches, turns forward then
reversed, twice).

``--full-card`` times ``FULL_CARD_VARIANTS`` (base, ``popc_pick``,
which must stay bitwise, and the three knock-outs) where the card is
full: the first ``FULL_CARD_K`` queries of the n1r 8 and the n1r 16
group of ``--groups``' list, each as one tile at r = 4096 (one
``sa_search`` of 128 chains x 32 restarts in order, LORDER on, LSOLN
off, ~60 waves of CTAs), against the seed's 14,291-entry DB; CUDA
events, two calls a turn, the variants forward then reversed.  Each
part's share of a full-card move is 1 - its knock-out's time over the
base's.

``--groups`` takes the kernel as it is through one list of the
benchmark cell ``astral14291_r4096.query200`` (the seed's 14,291-entry
DB made by ``satbench.deploy.prepare``, the seed's first window list of
``satbench.gen.Traffic``, r = 4096, LORDER on, LSOLN off).  It searches
the list once inside ``trace.recording()`` and prints, per
``kernel_search.enqueue`` span, the tile's n1r, queries K, restart split
S = ``ctas`` / (K x the plan's entries), lanes
(``sa_kernel.launch_shape``) and waves = ``ctas`` / ``cta_slots``.
Then each round8 group of the list is searched alone (``search_many``
of its queries, host wall, two turns): ms, Mit/s and the share of
``satbench.bound``'s least time.  Each one-query group is timed split
as the rule gives it and unsplit (``sa_kernel.restart_split`` stubbed
to 1) in turns, three each, under one tag, and the two must agree
bitwise.  Last, the
list's ``score_stats`` (norm2, z, p, as the benchmark's program takes
them) are timed in its ``stats.score_stats`` spans and twice more over
the same scores.
"""

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import sa_kernel  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.common import round8  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    launch_figures, make_plan, pack_queries)
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

AHEAD = """      const float u_move = nx_move, u_cand = nx_cand, u_acc = nx_acc;
      if (it + 1 < p.maxiter)  // move it+1's draws, off the chain
        draw_move(n1r + 3 * (it + 1), nx_move, nx_cand, nx_acc);"""
NO_AHEAD = """      float u_move, u_cand, u_acc;
      draw_move(n1r + 3 * it, u_move, u_cand, u_acc);"""
AHEAD_NOBRANCH = """      const float u_move = nx_move, u_cand = nx_cand, u_acc = nx_acc;
      draw_move(n1r + 3 * min(it + 1, p.maxiter - 1), nx_move, nx_cand,
                nx_acc);"""
FNS = "newj = 32 * w + static_cast<int>(__fns(cand[w], 0, rank + 1));"
POPC = """{
            uint32_t m = cand[w];
            int pos = 0, rk = rank;
#pragma unroll
            for (int sh = 16; sh; sh >>= 1) {
              const int cnt = __popc(m & ((1u << sh) - 1u));
              if (rk >= cnt) {
                rk -= cnt;
                m >>= sh;
                pos += sh;
              }
            }
            newj = 32 * w + pos;
          }"""
# the screened Metropolis test of in-kernel draws, and its knock-out
LOG_KNOCK = ("""        const float prod = __fmul_rn(temp, fast_ln(u_acc));
        const float margin = __fmul_rn(temp, p.screen);
        accept = fdelta > __fadd_rn(prod, margin);
        const bool near = !accept && !(fdelta < __fsub_rn(prod, margin));
        const unsigned active = __activemask();
        if (__any_sync(active, near)) {
          if (near)
            accept = fdelta >
                     __fmul_rn(temp, __ldg(ln_grid + grid_index(u_acc)));
          if (exact != nullptr && (tid & 31) == __ffs(active) - 1)
            atomicAdd(exact, 1ull);
        }
""", """        accept = fdelta > __fmul_rn(temp, __logf(u_acc));
""")
THREEFRY = "  uint32_t x0 = 0, x1 = i;\n  threefry2x32(k0, k1, x0, x1);\n"
DELTA = "        uint32_t m = word(mapped, w);\n"


def rewrite(src: str, *edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the kernel source no longer holds:\n{old}")
        src = src.replace(old, new)
    return src


RNG_KNOCK = (THREEFRY,
             "  uint32_t x0 = i * 0x9E3779B9u ^ k0, x1 = i + k1;\n")
DELTA_KNOCK = (DELTA, "        uint32_t m = 0u;\n")
# name -> the edits that make it; the design variants are bitwise
DESIGN = {"base": (), "no_ahead": ((AHEAD, NO_AHEAD),),
          "ahead_nobranch": ((AHEAD, AHEAD_NOBRANCH),),
          "popc_pick": ((FNS, POPC),)}
KNOCK = {"knock_log": (LOG_KNOCK,), "knock_rng": (RNG_KNOCK,),
         "knock_delta": (DELTA_KNOCK,),
         "knock_all": (LOG_KNOCK, RNG_KNOCK, DELTA_KNOCK)}
FULL_CARD_VARIANTS = ("base", "popc_pick", "knock_log", "knock_rng",
                      "knock_delta")
FULL_CARD_K = 8  # queries of a full-card tile
# the library's entry points that a variant's build binds as the port's
LIBRARY_FUNCTIONS = ("sa_search_launch", "sa_search_prepare",
                     "sa_search_smem_bytes", "sa_search_occupancy",
                     "sa_search_ln_grid", "sa_search_error_string",
                     "add_one_launch")


def variants(src: str, names) -> dict:
    """{name: source} of the named variants (``DESIGN``, ``KNOCK``)."""
    return {name: rewrite(src, *{**DESIGN, **KNOCK}[name]) for name in names}


def build(sources: dict) -> dict:
    """{name: Library} of each variant, built side by side."""
    vdir = sa_kernel.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    nvcc = sa_kernel.find_nvcc()
    warm = str(sa_kernel.SOURCES[1])
    procs = {}
    for name, text in sources.items():
        cu = vdir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *sa_kernel.NVCC_FLAGS, "-shared", "-o",
             str(vdir / f"{name}.so"), str(cu), warm],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = sa_kernel.load_library().lib
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in log.splitlines() if "registers" in ln})
        print(f"{name}: ptxas registers {regs}", flush=True)
        lib = ctypes.CDLL(str(vdir / f"{name}.so"))
        for fn in LIBRARY_FUNCTIONS:
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = sa_kernel.Library(lib=lib, path=vdir / f"{name}.so",
                                       build_s=0.0, log=log)
    return libs


def lanes_probe() -> int:
    """``--lanes`` (module docstring)."""
    lib = sa_kernel.load_library()
    for ln in lib.log.splitlines():
        if "registers" in ln or "spill" in ln or "Function prop" in ln:
            print(f"ptxas: {ln.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    sess = SearchSession(chip_smoke.DB586, SessionConfig(maxstart=128,
                                                         device=str(dev)))
    (full,) = sess.device_db
    wide, narrow = (make_plan([b for b, _ in cls.buckets])
                    for cls in full.classes)
    assert [c.d2max > 32 for c in full.classes] == [True, False]
    by_width = {}
    for name, order in zip(sess.db.names, sess.db.orders):
        by_width.setdefault(round8(int(order)), []).append(name)
    queries = {}  # (width, name) -> packed query
    for width, names in sorted(by_width.items()):
        for name in names[:2]:
            queries[(width, name)] = pack_queries(
                [sess.resolve_query(name)], width, dev)
    real = sa_kernel.chain_lanes
    for width in sorted(by_width):
        rule = sa_kernel.launch_shape(full, 1, width, c_par=128, r_seq=1,
                                      lsoln=True)[1]
        print(f"n1r {width} ({len(by_width[width])} DB entries): the rule "
              f"gives (wide, narrow) = {rule}", flush=True)
        for cls in full.classes:
            print(f"  d2 {cls.d2max} ({cls.entries} CTAs): (CTAs per SM, "
                  f"registers, local bytes) by G " + ", ".join(
                      f"{g}: {sa_kernel.occupancy(cls.d2max, width, 128, True, lanes=g)}"
                      for g in sa_kernel.LANES), flush=True)

    def search(q, plan, lanes):
        sa_kernel.chain_lanes = lambda *a, **k: lanes
        try:
            return sa_kernel.sa_search(*q, plan, seed=2 ** 31 - 5, tags=[3],
                                       c_par=128, r_seq=1, lorder=True,
                                       lsoln=True)
        finally:
            sa_kernel.chain_lanes = real

    runs = {}
    for (width, name), q in queries.items():
        for gn in (1, 2):
            for gw in sa_kernel.LANES:
                runs[(width, name, "pair", gn, gw)] = (q, full, (gw, gn))
    for (width, name), q in queries.items():
        if width in (16, 56) and name == by_width[width][0]:
            for g in sa_kernel.LANES:
                runs[(width, name, "narrow", g, 0)] = (q, narrow, (g,))
                runs[(width, name, "wide", 0, g)] = (q, wide, (g,))
    ref = {}
    for key, (q, plan, lanes) in runs.items():
        got = search(q, plan, lanes)
        torch.cuda.synchronize()
        base = ref.setdefault(key[:3], search(q, plan, (1,) * len(lanes)))
        if not (torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])):
            raise SystemExit(f"lanes {lanes} differ from G = 1 on {key}")
    print(f"every G == G 1 bitwise on {len(runs)} runs (scores and maps)",
          flush=True)
    order = list(runs)
    times = {}
    for key in order + order[::-1] + order + order[::-1]:
        q, plan, lanes = runs[key]
        times.setdefault(key, []).append(
            chip_smoke.cuda_ms(lambda: search(q, plan, lanes), 30))
    print(chip_smoke.card_line())
    med = {}
    for key in order:
        width, name, what, gn, gw = key
        t = sorted(times[key])
        med[key] = (t[1] + t[2]) / 2
        print(f"n1r {width} {name} {what:6s} narrow G {gn} wide G {gw}: "
              f"median {med[key]:.4f} ms "
              f"({' / '.join(f'{x:.4f}' for x in times[key])})")
    # each pair's time as a share of (1, 1), and the DB-weighted mean
    # (the interactive cell draws its queries from the DB's entries)
    total = sum(len(v) for v in by_width.values())
    for gn in (1, 2):
        for gw in sa_kernel.LANES:
            mean = base = 0.0
            for (width, name) in queries:
                w = len(by_width[width]) / min(2, len(by_width[width]))
                mean += w * med[(width, name, "pair", gn, gw)] / total
                base += w * med[(width, name, "pair", 1, 1)] / total
            print(f"narrow G {gn} wide G {gw}: DB-weighted mean "
                  f"{mean:.4f} ms ({100 * (mean / base - 1):+.1f} % on "
                  f"(1, 1)); by width " + ", ".join(
                      f"{width}: {100 * (med[(width, name, 'pair', gn, gw)] / med[(width, name, 'pair', 1, 1)] - 1):+.1f} %"
                      for width, name in queries))
    return 0


def groups_probe(seed: int) -> int:
    """``--groups`` (module docstring)."""
    from cuda_satabsearch_tpu_torch import trace
    from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats
    from satbench import bound, deploy
    from satbench.cells import load_cell
    from satbench.gen import Traffic

    cell = load_cell("astral14291_r4096.query200")
    maxstart, maxiter = cell.config["maxstart"], cell.config["maxiter"]
    dep = deploy.prepare(cell.config_name, cell.config, seed)
    index = dep.index
    sess = SearchSession(str(dep.path), SessionConfig(
        maxstart=maxstart, seed=seed % 2 ** 31))
    (plan,) = sess.device_db
    kw = sess.searcher.kw
    columns = plan.nentries
    E = len(index.names)
    picks = Traffic(cell.traffic, index.orders, seed).next_call()
    qs = [sess.resolve_query(index.names[i]) for i in picks]
    print(f"{cell.name} seed {seed}: {len(qs)} queries, {E} entries, "
          f"r = {maxstart}, classes (d2max, entries) "
          f"{[(c.d2max, c.entries) for c in plan.classes]}", flush=True)

    trace.clear()
    with trace.recording():
        t0 = time.perf_counter()
        results = sess.search_many(qs, lorder=True, lsoln=False)
        wall = time.perf_counter() - t0
        for q, r in zip(qs, results):
            score_stats(r.scores, q.order, r.orders)
    spans = trace.spans()
    its = len(qs) * E * maxstart * maxiter
    print(f"the list, first search: {wall:.3f} s, {its / wall / 1e6:.1f} "
          "Mit/s", flush=True)
    print("n1r K S lanes waves (one line per enqueue span)")
    for s in spans:
        if s.name != "kernel_search.enqueue":
            continue
        S, lanes = sa_kernel.launch_shape(plan, s.queries, s.n1r,
                                          c_par=kw["c_par"],
                                          r_seq=kw["r_seq"], lsoln=False)
        assert s.ctas == s.queries * columns * S, (s, S, columns)
        print(f"{s.n1r} {s.queries} {S} {lanes} "
              f"{s.ctas / s.cta_slots:.2f}", flush=True)
    stats_ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans
                if s.name == "stats.score_stats"]

    groups = {}
    for q in qs:
        groups.setdefault(round8(q.order), []).append(q)
    card = torch.cuda.get_device_name(0)
    print(chip_smoke.card_line())
    print("n1r K alone ms (two turns) Mit/s share of the bound")
    for n1r, group in sorted(groups.items()):
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            sess.search_many(group, lorder=True, lsoln=False)
            ms.append(1e3 * (time.perf_counter() - t0))
        n1s = [q.order for q in group]
        least = bound.bound_s(bound.search_ops(n1s, E, maxstart, maxiter),
                              bound.search_bytes(n1s, index.orders, False),
                              card)
        best = min(ms)
        share = "n/a" if least is None else f"{100e3 * least / best:.1f} %"
        print(f"{n1r} {len(group)} {ms[0]:.1f} / {ms[1]:.1f} "
              f"{len(group) * E * maxstart * maxiter / best / 1e3:.1f} "
              f"{share}", flush=True)

    real, searcher = sa_kernel.restart_split, sess.searcher
    unsplit = lambda *a, **k: 1  # noqa: E731
    for n1r, group in sorted(groups.items()):
        if len(group) != 1:
            continue
        S = sa_kernel.launch_shape(plan, 1, n1r, c_par=kw["c_par"],
                                   r_seq=kw["r_seq"], lsoln=False)[0]
        times, scores = {"split": [], "unsplit": []}, {}
        for _ in range(3):
            for name, rule in (("split", real), ("unsplit", unsplit)):
                sa_kernel.restart_split = rule
                try:
                    t0 = time.perf_counter()
                    (res,) = searcher.drain([searcher.launch(
                        group, [2 ** 20], lorder=True, lsoln=False)])[0]
                    times[name].append(1e3 * (time.perf_counter() - t0))
                finally:
                    sa_kernel.restart_split = real
                scores.setdefault(name, res.scores)
        if not np.array_equal(scores["split"], scores["unsplit"]):
            raise SystemExit(f"n1r {n1r}: split scores differ from unsplit")
        print(f"single n1r {n1r} (order {group[0].order}) S {S}: split "
              f"{' / '.join(f'{t:.1f}' for t in times['split'])} ms, "
              f"unsplit "
              f"{' / '.join(f'{t:.1f}' for t in times['unsplit'])} ms, "
              "scores equal", flush=True)

    again = []
    for _ in range(2):
        t0 = time.perf_counter()
        for q, r in zip(qs, results):
            score_stats(r.scores, q.order, r.orders)
        again.append((time.perf_counter() - t0) * 1e3 / len(qs))
    print(f"score_stats ms a query: in the list's spans "
          f"{sum(stats_ms) / len(qs):.4f} (first {stats_ms[0]:.4f}, median "
          f"{float(np.median(stats_ms)):.4f}); over the same scores again "
          f"{again[0]:.4f}, {again[1]:.4f}", flush=True)
    return 0


def full_card_probe(seed: int) -> int:
    """``--full-card`` (module docstring)."""
    from satbench import deploy
    from satbench.cells import load_cell
    from satbench.gen import Traffic

    cell = load_cell("astral14291_r4096.query200")
    dep = deploy.prepare(cell.config_name, cell.config, seed)
    index = dep.index
    sess = SearchSession(str(dep.path), SessionConfig(
        maxstart=cell.config["maxstart"], seed=seed % 2 ** 31))
    (plan,) = sess.device_db
    kw = sess.searcher.kw
    dev = plan.device
    picks = Traffic(cell.traffic, index.orders, seed).next_call()
    groups = {}
    for i in picks:
        q = sess.resolve_query(index.names[i])
        groups.setdefault(round8(q.order), []).append(q)
    tiles = {n1r: pack_queries(groups[n1r][:FULL_CARD_K], n1r, dev)
             for n1r in (8, 16)}
    libs = build(variants(sa_kernel.SOURCES[0].read_text(),
                          FULL_CARD_VARIANTS))
    real = sa_kernel.load_library

    def search(name, q):
        sa_kernel.load_library = lambda: libs[name]
        try:
            return sa_kernel.sa_search(
                *q, plan, seed=seed % 2 ** 31, tags=list(range(len(q[3]))),
                c_par=kw["c_par"], r_seq=kw["r_seq"], lorder=True,
                lsoln=False)
        finally:
            sa_kernel.load_library = real

    for n1r, q in tiles.items():
        S, lanes = sa_kernel.launch_shape(plan, len(q[3]), n1r,
                                          c_par=kw["c_par"],
                                          r_seq=kw["r_seq"], lsoln=False)
        ctas, slots, _ = launch_figures(plan, len(q[3]), n1r,
                                        c_par=kw["c_par"], r_seq=kw["r_seq"],
                                        lsoln=False, maxiter=100)
        base = search("base", q)[0]
        if not torch.equal(search("popc_pick", q)[0], base):
            raise SystemExit(f"popc_pick differs from the kernel at n1r {n1r}")
        print(f"n1r {n1r}: {len(q[3])} queries x {plan.nentries} entries, "
              f"r = {cell.config['maxstart']} (c_par {kw['c_par']} x r_seq "
              f"{kw['r_seq']}), S {S}, lanes {lanes}, {ctas / slots:.1f} "
              "waves; popc_pick == base bitwise", flush=True)
    names = list(FULL_CARD_VARIANTS)
    times = {}
    for name in names + names[::-1]:
        for n1r, q in tiles.items():
            times.setdefault((n1r, name), []).append(
                chip_smoke.cuda_ms(lambda: search(name, q), 2))
    print(chip_smoke.card_line())
    for n1r in tiles:
        base = float(np.median(times[(n1r, "base")]))
        print(f"n1r {n1r} (ms a launch, CUDA events; share of a move: "
              "1 - variant / base):")
        for name in names:
            t = times[(n1r, name)]
            print(f"  {name:12s} {' / '.join(f'{x:.2f}' for x in t)}  "
                  f"{100 * (1 - float(np.median(t)) / base):+.1f} %",
                  flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--lanes"]:
        return lanes_probe()
    if sys.argv[1:2] == ["--groups"]:
        return groups_probe(int(sys.argv[2]) if len(sys.argv) > 2
                            else 3100002031)
    if sys.argv[1:2] == ["--full-card"]:
        return full_card_probe(int(sys.argv[2]) if len(sys.argv) > 2
                               else 3100002031)
    src = sa_kernel.SOURCES[0].read_text()
    design, knock = list(DESIGN), list(KNOCK)
    libs = build(variants(src, design + knock))
    dev = torch.device("cuda", 0)
    sess = SearchSession(chip_smoke.DB586, SessionConfig(maxstart=128,
                                                         device=str(dev)))
    (full,) = sess.device_db
    one80 = make_plan([b for b in full.buckets if b.dim == 80])
    q8 = pack_queries(chip_smoke.read_query("d1ubia_.input"), 8, dev)
    q19 = pack_queries(chip_smoke.read_query("d2phlb1.input"), 24, dev)
    runs = {"586db d1ubia_ r=128, full plan": (q8, full, 1),
            "586db d1ubia_ r=128, the 80-wide entry alone": (q8, one80, 1),
            "586db d2phlb1 r=4096, full plan": (q19, full, 32)}
    real = sa_kernel.load_library

    def search(name, q, plan, r_seq):
        sa_kernel.load_library = lambda: libs[name]
        try:
            return sa_kernel.sa_search(*q, plan, seed=1234, tags=[0],
                                       c_par=128, r_seq=r_seq, lorder=True,
                                       lsoln=True)
        finally:
            sa_kernel.load_library = real

    ref = {r: search("base", *args) for r, args in runs.items()}
    for name in design[1:]:
        for r, args in runs.items():
            s, m = search(name, *args)
            torch.cuda.synchronize()
            if not (torch.equal(s, ref[r][0]) and torch.equal(m, ref[r][1])):
                raise SystemExit(f"{name} differs from the kernel on {r}")
    print(f"design variants {design[1:]} == the kernel bitwise "
          f"(scores and maps) on every run", flush=True)
    names = design + knock
    times = {}
    for name in names + names[::-1]:
        for r, args in runs.items():
            reps = 5 if args[2] > 1 else 20
            times.setdefault((r, name), []).append(
                chip_smoke.cuda_ms(lambda: search(name, *args), reps))
    print(chip_smoke.card_line())
    for r in runs:
        print(f"{r} (ms, CUDA events):")
        for name in names:
            print(f"  {name:15s} " + " / ".join(
                f"{t:.4f}" for t in times[(r, name)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
