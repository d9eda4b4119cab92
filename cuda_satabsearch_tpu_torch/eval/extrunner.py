"""External comparison-tool runner: the QP-search / TOPS wrapper twin.

Copy of cuda_satabsearch_tpu/eval/extrunner.py (that package imports jax).

The reference drives sibling-project search programs over query
directories with a family of thin shell/Python wrappers
(scripts/qptabmatch_allall.py, qptabmatch_allall_nodbfile.py,
qptabmatch_allpairs.py, build_tops_files.sh, tops_to_strings.sh):
each walks a directory of per-structure input files, runs one external
program per file (or file pair), and collects per-query ``.out`` /
``.err`` files in a results directory that the eval layer then consumes
(via the out2col adapters, eval/adapters.py).

This module replaces that family with ONE configurable runner:

* ``run_per_file``  — one invocation per input file (qptabmatch_allall,
  qptabmatch_allall_nodbfile, build_tops_files, tops_to_strings);
* ``run_all_pairs`` — one invocation per ordered file pair
  (qptabmatch_allpairs.py's n*n comparisons).

The command is a template with ``{query}`` (input path), ``{query2}``
(second input, pairs mode), ``{db}`` (database file), and ``{name}``
(input stem) placeholders; stdin can be fed the query file instead
(``stdin=True``) for tools with the tsrchd-style read-from-stdin
protocol.  Results land as ``<results_dir>/<name>.out`` (+ ``.err``),
exactly the layout the reference wrappers produce, so downstream eval
(`--multiquery-dir`, adapters) works unchanged.

No external search tools are bundled in this environment, so the unit
tests drive the runner with stand-in commands; point ``--program`` at a
real tsrchd/tops binary to reproduce the reference workflows.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
from dataclasses import dataclass


@dataclass
class RunResult:
    name: str
    out_path: str
    returncode: int


def _stem(path: str, suffix: str) -> str:
    base = os.path.basename(path)
    if suffix and base.endswith(suffix):
        base = base[: -len(suffix)]
    return base


def _inputs(query_dir: str, suffix: str) -> list[str]:
    pat = os.path.join(query_dir, f"*{suffix}" if suffix else "*")
    return sorted(p for p in glob.glob(pat) if os.path.isfile(p))


def _run_one(command: str, subs: dict, out_path: str, err_path: str,
             stdin_path: str | None, timeout: float | None) -> int:
    cmd = command.format(**subs)
    stdin_fh = open(stdin_path, "rb") if stdin_path else subprocess.DEVNULL
    try:
        with open(out_path, "wb") as out_fh, open(err_path, "wb") as err_fh:
            # start_new_session puts the shell AND its children in a
            # fresh process group, so a timeout kills grandchildren too
            # — otherwise they survive the shell and keep writing to
            # this run's .out/.err, polluting later sweep results
            proc = subprocess.Popen(cmd, shell=True, stdin=stdin_fh,
                                    stdout=out_fh, stderr=err_fh,
                                    start_new_session=True)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                # a hung tool fails THIS run, not the whole sweep; 124
                # matches coreutils timeout(1)
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                proc.wait()
                return 124
    finally:
        if stdin_path:
            stdin_fh.close()
    return proc.returncode


def run_per_file(command: str, query_dir: str, results_dir: str, *,
                 suffix: str = ".tableaudistmatrix", db_file: str = "",
                 stdin: bool = False, out_suffix: str = ".out",
                 timeout: float | None = None,
                 log=None) -> list[RunResult]:
    """One external invocation per ``*<suffix>`` file in ``query_dir``
    (qptabmatch_allall.py:80-120 semantics: per-query ``.out``/``.err``
    files in ``results_dir``, which is created if missing)."""
    os.makedirs(results_dir, exist_ok=True)
    results = []
    for path in _inputs(query_dir, suffix):
        name = _stem(path, suffix)
        out_path = os.path.join(results_dir, name + out_suffix)
        err_path = os.path.join(results_dir, name + ".err")
        rc = _run_one(command, {"query": path, "db": db_file, "name": name},
                      out_path, err_path, path if stdin else None, timeout)
        results.append(RunResult(name, out_path, rc))
        if log:
            log(f"{name}: rc={rc}")
    return results


def run_all_pairs(command: str, query_dir: str, results_dir: str, *,
                  suffix: str = ".tableaudistmatrix",
                  stdin: bool = False, timeout: float | None = None,
                  log=None) -> list[RunResult]:
    """One invocation per ordered pair of inputs (n*n comparisons,
    qptabmatch_allpairs.py); outputs ``<a>__<b>.out``."""
    os.makedirs(results_dir, exist_ok=True)
    paths = _inputs(query_dir, suffix)
    results = []
    for pa in paths:
        for pb in paths:
            na, nb = _stem(pa, suffix), _stem(pb, suffix)
            name = f"{na}__{nb}"
            out_path = os.path.join(results_dir, name + ".out")
            err_path = os.path.join(results_dir, name + ".err")
            rc = _run_one(command,
                          {"query": pa, "query2": pb, "name": name,
                           "db": ""},
                          out_path, err_path, pa if stdin else None,
                          timeout)
            results.append(RunResult(name, out_path, rc))
            if log:
                log(f"{name}: rc={rc}")
    return results


def collect_2col(results: list[RunResult], adapter: str, outdir: str,
                 **adapter_kwargs) -> list[str]:
    """Normalize each run's output through an out2col adapter
    (eval/adapters.py) into ``<outdir>/<name>.2col`` files the eval CLI
    consumes directly."""
    from .adapters import ADAPTERS, write_2col

    fn = ADAPTERS[adapter]
    os.makedirs(outdir, exist_ok=True)
    out = []
    for r in results:
        path = os.path.join(outdir, r.name + ".2col")
        with open(r.out_path) as fh, open(path, "w") as ofh:
            write_2col(fn(fh, **adapter_kwargs), ofh)
        out.append(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.eval.extrunner",
        description="Run an external comparison tool over a query "
                    "directory (QP-search / TOPS wrapper twin)")
    ap.add_argument("--program", required=True,
                    help="command template; placeholders {query} "
                         "{query2} {db} {name}")
    ap.add_argument("--query-dir", required=True)
    ap.add_argument("--results-dir", required=True)
    ap.add_argument("--db", default="", help="database file ({db})")
    ap.add_argument("--suffix", default=".tableaudistmatrix")
    ap.add_argument("--out-suffix", default=".out")
    ap.add_argument("--stdin", action="store_true",
                    help="feed the query file on stdin (tsrchd protocol)")
    ap.add_argument("--pairs", action="store_true",
                    help="all ordered pairs (qptabmatch_allpairs)")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--adapter", default=None,
                    help="normalize outputs to 2-col via this "
                         "eval.adapters name")
    ap.add_argument("--adapter-outdir", default=None)
    args = ap.parse_args(argv)

    log = lambda msg: print(msg, file=sys.stderr)
    if args.pairs:
        results = run_all_pairs(args.program, args.query_dir,
                                args.results_dir, suffix=args.suffix,
                                stdin=args.stdin, timeout=args.timeout,
                                log=log)
    else:
        results = run_per_file(args.program, args.query_dir,
                               args.results_dir, suffix=args.suffix,
                               db_file=args.db, stdin=args.stdin,
                               out_suffix=args.out_suffix,
                               timeout=args.timeout, log=log)
    failed = [r for r in results if r.returncode != 0]
    if args.adapter:
        outdir = args.adapter_outdir or args.results_dir
        collect_2col([r for r in results if r.returncode == 0],
                     args.adapter, outdir)
    print(f"{len(results)} runs, {len(failed)} failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
