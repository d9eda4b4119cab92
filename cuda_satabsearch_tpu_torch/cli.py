"""torchsatabsearch — drop-in CLI for SA tableau search on an NVIDIA GPU.

Counterpart of cuda_satabsearch_tpu/cli.py, flag- and protocol-
compatible with the reference's host program (cudaSaTabsearch.cu:573-700):

* standard mode: stdin carries a ``dbfile`` line, an options line
  ``T|F T|F T|F`` (LTYPE LORDER LSOLN), then query tableaux+distmatrices;
* ``-q DBFILE``: query-list mode — stdin carries structure identifiers
  resolved against the database; LTYPE=T LORDER=T LSOLN=F forced;
* ``-r N``: number of SA restarts (default 128);
* ``-c``: run the plain PyTorch engine on the CPU (the reference's
  ``-c`` runs its host-compiled kernel).

Extensions: ``--mesh`` (shard the DB entries over all visible CUDA
devices; with ``-c``, over the CPU device), ``--backend
{auto,cuda,torch}`` (the CUDA kernel, or the plain PyTorch engine on the
card), ``--compat-z`` (the reference's int-truncated z-scores),
``--seed N``, ``--cmax N``.

stdout carries results; all telemetry goes to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time

from .core.constants import DEFAULT_MAXSTART, MAXDIM
from .io.pack import pack_query
from .io.parser import parse_search_input
from .ops.sa_kernel import sa_search
from .session import (SearchSession, SessionConfig, format_results,
                      print_query_header)

PROGRAM = "torchsatabsearch"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROGRAM,
        description="Simulated-annealing tableau search (PyTorch + CUDA)")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run the plain engine on the CPU")
    ap.add_argument("-q", "--querydb", metavar="DBFILE", default=None,
                    help="query-list mode: read query ids from stdin, "
                         "resolve them in DBFILE")
    ap.add_argument("-r", "--restarts", type=int, default=DEFAULT_MAXSTART,
                    help="number of SA restarts per entry (default 128)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard DB entries across all visible CUDA devices "
                         "(with -c: the CPU device)")
    ap.add_argument("--backend", choices=("auto", "cuda", "torch"),
                    default="auto",
                    help="SA search: the CUDA kernel, or the plain PyTorch "
                         "engine (auto: the kernel)")
    ap.add_argument("--compat-z", action="store_true",
                    help="reproduce reference int-truncated z-scores")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--cmax", type=int, default=128,
                    help="max parallel chains per entry (at most 128)")
    return ap


def main(argv=None) -> int:
    """CLI entry point; returns a process exit status.

    Errors in input parsing / DB loading, and a missing card, print an
    ERROR line and return 1 (the reference's behavior for the same
    failures, cudaSaTabsearch.cu:667-712), rather than tracebacks.
    """
    try:
        return _run(argv)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _run(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    err = sys.stderr
    print(f"MAXDIM = {MAXDIM}", file=err)
    config = SessionConfig(maxstart=args.restarts, seed=args.seed,
                           c_max=args.cmax, compat_z=args.compat_z,
                           backend=args.backend,
                           device="cpu" if args.cpu else None,
                           use_mesh=args.mesh,
                           devices=["cpu"] if args.cpu else None)

    if args.querydb is not None:
        # query-list mode (cudaSaTabsearch.cu:631-664): LTYPE/LORDER=T,
        # LSOLN=F forced
        qids = [line.strip() for line in sys.stdin if line.strip()]
        dbfile = args.querydb
        ltype, lorder, lsoln = True, True, False
        queries = None
    else:
        sin = parse_search_input(sys.stdin)
        dbfile = sin.dbfile
        ltype, lorder, lsoln = sin.ltype, sin.lorder, sin.lsoln
        if not ltype:
            print("WARNING: LTYPE is always set to T", file=err)
            ltype = True
        if not sin.queries:
            print("ERROR: no query structures found on stdin", file=err)
            return 1
        print(f"Read {len(sin.queries)} query structures", file=err)
        queries = [pack_query(q) for q in sin.queries]
        qids = [q.name for q in queries]

    print("Loading database...", file=err)
    session = SearchSession(dbfile, config)
    print(f"Loaded {session.nentries} db entries "
          f"({session.load_ms:.1f} ms load, "
          f"{session.upload_ms:.1f} ms device upload, "
          f"{session.backend} on "
          f"{', '.join(map(str, session.mesh or [session.device]))})",
          file=err)
    print(f"maxstart = {args.restarts}", file=err)

    # query-list ids resolve against the resident DB; qn passed to the
    # stats is the resolved query's order (the reference indexes the
    # wrong array here, cudaSaTabsearch.cu:997 — fixed, not replicated)
    resolved: list[tuple[str, object]] = []
    if queries is not None:
        resolved = list(zip(qids, queries))
    else:
        for qid in qids:
            query = session.resolve_query(qid)
            if query is None:
                print(f"ERROR: query structure {qid} not found in db",
                      file=err)
                continue
            resolved.append((qid, query))
    if not resolved:
        return 1 if qids else 0

    launches = sa_search.launches
    t0 = time.perf_counter()
    results = session.search_many([q for _, q in resolved], lorder=lorder,
                                  lsoln=lsoln)
    dt = time.perf_counter() - t0
    for (qid, query), result in zip(resolved, results):
        print_query_header(PROGRAM, ltype, lorder, lsoln, qid, dbfile)
        format_results(result, query.order, lsoln=lsoln,
                       compat_z=config.compat_z)
    iters = (session.nentries * args.restarts
             * session.config.params.maxiter * len(resolved))
    print(f"search time {dt * 1000.0:.3f} ms "
          f"({len(resolved)} queries)", file=err)
    print(f"{iters / dt / 1.0e6:.1f} million iterations/sec", file=err)
    print(f"{sa_search.launches - launches} SA kernel launches", file=err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
