"""The end-to-end evaluation artifact: search, AUC tables, timing table.

The port of scripts/make_eval_artifact.py (the JAX package's driver,
which imports jax).  It drives the product pipeline and writes its
outputs to ``--out DIR``:

1. runs the bundled mixed-order multiquery stream
   (tests/fixtures/multiquery.input: 8-, 13- and 101-SSE queries vs the
   586-entry DB) through the port's CLI in a subprocess, once per row:
   ``h100-cuda`` (``--backend cuda``, the CUDA kernel) and
   ``h100-torch`` (``--backend torch``, the plain engine on the card:
   the counterpart of the JAX run's ``tpu-xla-engine`` row); with
   ``-c`` the one row ``cpu-torch`` (the plain engine on the CPU).
   Each row's time is the CLI's own ``search time N ms`` stderr line;
2. builds a gold-standard file from the reference CPU oracle outputs
   (top 5% by norm2 score, the acceptance-eval convention);
3. evaluates the first row with ``eval.__main__`` (auc_table.txt with
   ROC50 and slrtabs/, auc_table.tex) and writes the
   mkquery200timestab.sh-style AUC/time/speedup table (timestab.tex)
   through ``eval.timestab``;
4. writes runs.json: each row's label, search seconds, process wall
   seconds and the SA kernel launches its CLI reported.

    python -m cuda_satabsearch_tpu_torch.eval.make_eval_artifact \\
        --out DIR [--restarts 128] [--rows cuda torch] [-c]

Without a card and without ``-c`` it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

from .acceptance_eval import (FIXTURES, GOLDEN, REPO, check_out_dir,
                              load_scores, search_config, search_target)

ROWS = {"cuda": ("h100-cuda", ["--backend", "cuda"]),
        "torch": ("h100-torch", ["--backend", "torch"])}
CPU_ROW = ("cpu-torch", ["-c"])
GOLD_QUERIES = ("d1ubia_", "d1ae6h1")


def build_gold(path: str, frac: float = 0.05) -> list[str]:
    """Gold file: for each query with a reference-oracle golden, the
    oracle's top ``frac`` of DB entries by norm2 score are positives."""
    lines = []
    for qname in GOLD_QUERIES:
        ref = load_scores(os.path.join(GOLDEN, f"{qname}_small_r4096.out"))
        k = max(1, int(len(ref) * frac))
        top = sorted(ref, key=ref.get, reverse=True)[:k]
        lines.append(" ".join([qname] + sorted(top)))
    with open(path, "w") as fh:
        fh.write("# gold = reference CPU oracle top 5% by norm2 "
                 "(r=4096 goldens)\n")
        fh.write("\n".join(lines) + "\n")
    return list(GOLD_QUERIES)


def run_cli(outpath: str, restarts: int, cli_args: list[str]) -> dict:
    """Run the port's CLI on multiquery.input into ``outpath``; returns
    its search seconds (the CLI's 'search time N ms' stderr line), the
    process wall seconds and the SA kernel launches it reported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(os.path.join(FIXTURES, "multiquery.input")) as fin, \
            open(outpath, "w") as fout:
        proc = subprocess.run(
            [sys.executable, "-m", "cuda_satabsearch_tpu_torch",
             "-r", str(restarts)] + cli_args,
            stdin=fin, stdout=fout, stderr=subprocess.PIPE, cwd=FIXTURES,
            env=env)
    wall = time.perf_counter() - t0
    err = proc.stderr.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI exited {proc.returncode}: {err}")
    search = re.search(r"search time ([\d.]+) ms", err)
    launches = re.search(r"(\d+) SA kernel launches", err)
    if not (search and launches):
        raise RuntimeError(f"the CLI's stderr lacks its search time or "
                           f"launch count: {err}")
    return dict(seconds=float(search.group(1)) / 1e3, wall=wall,
                launches=int(launches.group(1)))


def _to_file(path: str, fn, argv) -> None:
    with open(path, "w") as fh, contextlib.redirect_stdout(fh):
        rc = fn(argv)
    if rc != 0:
        raise RuntimeError(f"{fn.__module__} {argv} exited {rc}")


def write_manifest(path: str, runs: list[dict]) -> None:
    """eval.timestab's manifest: one row per run, slowest first (the
    speed-up baseline), its search seconds to the microsecond (the CLI
    reports milliseconds to three decimals; a kernel row of a few ms
    rounded to 0.01 s would be 0 and divide the speed-up by zero)."""
    with open(path, "w") as fh:
        fh.write("# label\tresults\tseconds  (slowest row = baseline)\n")
        for run in sorted(runs, key=lambda r: -r["seconds"]):
            fh.write(f"{run['label']}\t{run['results']}\t"
                     f"{run['seconds']:.6f}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.eval.make_eval_artifact",
        description="multiquery search through the CLI -> AUC/ROC50 "
                    "tables, slrtabs and the AUC/time/speedup table")
    ap.add_argument("--out", required=True, metavar="DIR",
                    help="output directory (never eval_artifacts/)")
    ap.add_argument("--restarts", type=int, default=128)
    ap.add_argument("--rows", nargs="+", choices=sorted(ROWS),
                    default=["cuda", "torch"],
                    help="on the card: the kernel row, the plain-engine "
                         "row, or both (default)")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="one row, the plain engine on the CPU "
                         "(with --rows torch only)")
    args = ap.parse_args(argv)
    if args.cpu and args.rows != ["torch"]:
        ap.error("-c runs the plain engine only: use it with --rows torch")
    rows = [CPU_ROW] if args.cpu else [ROWS[r] for r in args.rows]

    from .__main__ import main as eval_main
    from .timestab import main as timestab_main

    try:
        out_dir = check_out_dir(args.out)
        where = search_target(search_config(args.cpu))
        print(f"# searching on {where}", file=sys.stderr)
        os.makedirs(out_dir, exist_ok=True)
        gold_path = os.path.join(out_dir, "gold_oracle_top5.txt")
        covered = build_gold(gold_path)
        print(f"gold standard written for {covered}", file=sys.stderr)
        runs = []
        for label, cli_args in rows:
            out = os.path.join(out_dir, f"multiquery_{label}.out")
            run = run_cli(out, args.restarts, cli_args)
            runs.append(dict(label=label, results=out, **run))
            print(f"{label}: search {run['seconds']:.3f} s, process "
                  f"{run['wall']:.1f} s, {run['launches']} SA kernel "
                  f"launches", file=sys.stderr)

        slrdir = os.path.join(out_dir, "slrtabs")
        first = runs[0]["results"]
        _to_file(os.path.join(out_dir, "auc_table.txt"), eval_main,
                 [first, "--gold", gold_path, "--roc50", "--slrtab-dir",
                  slrdir])
        _to_file(os.path.join(out_dir, "auc_table.tex"), eval_main,
                 [first, "--gold", gold_path, "--roc50", "--latex"])
        manifest = os.path.join(out_dir, "timestab_manifest.tsv")
        write_manifest(manifest, runs)
        _to_file(os.path.join(out_dir, "timestab.tex"), timestab_main,
                 [manifest, "--gold", gold_path])
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(out_dir, "runs.json"), "w") as fh:
        json.dump({"restarts": args.restarts, "rows": runs}, fh, indent=1)
    print(f"artifact written to {out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
