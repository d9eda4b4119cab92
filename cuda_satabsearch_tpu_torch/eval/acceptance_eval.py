"""Acceptance evaluation: ranking parity against the reference CPU oracle.

The port of scripts/acceptance_eval.py (the JAX package's driver, which
imports jax).  The queries d1ubia_, d1ae6h1 and d2phlb1 run against the
586-entry DB through ``SearchSession`` and are ranked by norm2 against
the outputs of the unmodified reference CPU code on the same inputs
(tests/fixtures/refgolden/): Spearman rank correlation, top-10/top-50
overlap, and retrieval AUC with gold = the oracle's top 5% (auc5).

The verdict is taken on d2phlb1 at r = 4096.  Where the reference's
archived GPU and CPU run logs are found under ``--reflog``, the bar is
the reference's own GPU-vs-CPU auc5 less 0.01 (BASELINE.md's "within
1%"), computed from the logs.  Elsewhere it is that floor as
ACCEPTANCE.md:20 records it, 0.9915 - 0.01, and the report says so.
chip_smoke.py's acceptance phase uses ``parity_rows`` and ``verdict``.

    python -m cuda_satabsearch_tpu_torch.eval.acceptance_eval \\
        [--restarts 128 4096] [-c] [--backend auto|cuda|torch] \\
        [--reflog DIR] [--out DIR]

Searches on the card with the CUDA kernel by default; ``-c`` runs the
plain engine on the CPU (``-c --backend cuda`` is refused).  Without a
card and without ``-c`` it exits 1.
Writes the markdown report to stdout, or to DIR/acceptance.md; exits 1
when the verdict is FAIL.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GOLDEN = os.path.join(FIXTURES, "refgolden")
DB586 = os.path.join(FIXTURES, "tableauxdistmatrixdb.small.ascii")
# the reference's archived 2012 run logs of d2phlb1 at r = 4096 on the
# 586-entry DB (old/nvcc_src_cuda5/ in its source tree)
CPU_LOG = "cpu_cudaSaTabsearch.o1462445"
GPU_LOG = "gpucudaSaTabsearch_fermi.o1462444"

# the acceptance queries and their SSE counts (scripts/acceptance_eval.py:37)
QUERIES = {"d1ubia_": 8, "d1ae6h1": 13, "d2phlb1": 19}
GATE = ("d2phlb1", 4096)
# the reference's own GPU-vs-CPU auc5 on the gate, from its archived
# logs (ACCEPTANCE.md:20); the bar is within 0.01 of it
REF_GPU_AUC5 = 0.9915
GATE_AUC5 = REF_GPU_AUC5 - 0.01


def load_scores(path, col=2) -> dict[str, float]:
    """{name: score} from a reference-format output file (col 2 = norm2
    size-normalized score, the ranking the eval layer uses;
    scripts/acceptance_eval.py:40-54)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 5:
                try:
                    out[parts[0]] = float(parts[col])
                except ValueError:
                    pass
    return out


def read_queries(name: str) -> list:
    """The packed queries of a tests/fixtures input file."""
    from ..io.pack import pack_query
    from ..io.parser import parse_search_input

    with open(os.path.join(FIXTURES, name)) as fp:
        return [pack_query(q) for q in parse_search_input(fp).queries]


def device_label(device) -> str:
    """The device a session searched on: 'cpu', or the card's name and
    power limit as nvidia-smi gives them."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return torch.cuda.get_device_name(index)


def parity_row(sess, qname: str, golden_r: int):
    """(ParityReport, ms) of one search of acceptance query ``qname`` on
    ``sess`` against the oracle's output at ``golden_r`` restarts,
    ranked by norm2 as scripts/acceptance_eval.py:108-118 ranks them."""
    from ..stats.gumbel import norm2
    from .acceptance import parity_report

    query = read_queries(f"{qname}.input")[0]
    t0 = time.perf_counter()
    res = sess.search(query, lorder=True, lsoln=False)
    ms = (time.perf_counter() - t0) * 1e3
    n1 = QUERIES[qname]
    ours = {res.names[i]: norm2(int(res.scores[i]), n1, int(res.orders[i]))
            for i in range(res.nentries)}
    ref = load_scores(os.path.join(GOLDEN, f"{qname}_small_r{golden_r}.out"))
    return parity_report(ours, ref), ms


def parity_rows(restarts, **config):
    """[(query, n1, r, ParityReport, ms)] for every acceptance query at
    every r in ``restarts``, one ``SearchSession`` per r made with
    ``SessionConfig(maxstart=r, **config)``, against the oracle's output
    at the same r.  Queries without an oracle output at that r are left
    out, with a line on stderr."""
    from ..session import SearchSession, SessionConfig

    rows = []
    for r in restarts:
        sess = SearchSession(DB586, SessionConfig(maxstart=r, **config))
        for qname, n1 in QUERIES.items():
            if not os.path.exists(os.path.join(
                    GOLDEN, f"{qname}_small_r{r}.out")):
                print(f"(skipping {qname} r={r}: no oracle output at "
                      f"r={r})", file=sys.stderr)
                continue
            rep, ms = parity_row(sess, qname, r)
            rows.append((qname, n1, r, rep, ms))
            print(f"{qname} r={r}: {rep.row()}  [{ms:.3f} ms]",
                  file=sys.stderr)
    return rows


def reference_floor(reflog: str | None):
    """The reference's own GPU-vs-CPU ParityReport from its archived
    logs in ``reflog``, or None where they are not there."""
    from .acceptance import parity_report

    if not reflog:
        return None
    cpu_log, gpu_log = (os.path.join(reflog, f) for f in (CPU_LOG, GPU_LOG))
    if not (os.path.exists(cpu_log) and os.path.exists(gpu_log)):
        return None
    return parity_report(load_scores(gpu_log), load_scores(cpu_log))


def verdict(rows, floor=None):
    """(passed, text) of the acceptance verdict on d2phlb1 at r = 4096,
    or None where that row was not run.  With the reference's floor
    (``reference_floor``) the bar is its auc5 less 0.01; without it,
    GATE_AUC5."""
    gate = [rep for q, _n1, r, rep, _ms in rows if (q, r) == GATE]
    if not gate:
        return None
    auc5 = gate[0].auc5
    if floor is not None:
        delta = auc5 - floor.auc5
        passed = delta >= -0.01
        return passed, (
            f"**Acceptance (d2phlb1 r=4096): our AUC {auc5:.4f} vs "
            f"reference-GPU AUC {floor.auc5:.4f} (delta {delta:+.4f}) -> "
            f"{'PASS' if passed else 'FAIL'}** (bar: within 0.01 of the "
            f"reference GPU's auc5 from its archived logs, BASELINE.md)")
    passed = auc5 >= GATE_AUC5
    return passed, (
        f"**Acceptance (d2phlb1 r=4096): our AUC {auc5:.4f}, bar >= "
        f"{GATE_AUC5:.4f} -> {'PASS' if passed else 'FAIL'}** (bar: the "
        f"reference GPU's auc5 {REF_GPU_AUC5} as ACCEPTANCE.md:20 records "
        f"it, less 0.01; the reference's archived logs were not found, "
        f"so this is the bar chip_smoke.py's acceptance phase uses)")


def report(rows, floor, where: str) -> str:
    """The markdown report (ACCEPTANCE.md's layout)."""
    out = ["# Acceptance evaluation — ranking parity vs reference CPU "
           "oracle\n",
           "Metrics: Spearman rank correlation over all 586 entries; "
           "top-10/top-50 overlap;\nretrieval AUC with gold = reference "
           "top 5% (by norm2 score).\n"]
    if floor is not None:
        out += ["## Reference noise floor (its own GPU vs CPU, d2phlb1 "
                "r=4096, archived 2012 logs)\n", f"    {floor.row()}\n"]
    out += [f"## This port vs reference CPU oracle ({where})\n",
            f"| query | n1 | restarts | spearman | top10 | top50 | auc5 | "
            f"ref-GPU auc5 | ms per query ({where}) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for qname, n1, r, rep, ms in rows:
        gpu_auc = (f"{floor.auc5:.4f}" if floor is not None
                   and (qname, r) == GATE else "")
        out.append(f"| {qname} | {n1} | {r} | {rep.spearman:.4f} | "
                   f"{rep.top10:.2f} | {rep.top50:.2f} | {rep.auc5:.4f} | "
                   f"{gpu_auc} | {ms:.3f} |")
    out.append("")
    v = verdict(rows, floor)
    out.append(v[1] if v else "No verdict: d2phlb1 at r=4096 was not run.")
    return "\n".join(out) + "\n"


def check_out_dir(path: str) -> str:
    """``path`` made absolute.  The JAX package's committed evaluation
    artifacts are never written: not eval_artifacts/, and not the
    repository's root, which holds its ACCEPTANCE.md."""
    path = os.path.abspath(path)
    guarded = os.path.join(REPO, "eval_artifacts")
    if os.path.commonpath([path, guarded]) == guarded or path == REPO:
        raise ValueError(f"--out {path}: eval_artifacts/ and the "
                         f"repository's root hold the JAX package's "
                         f"artifacts; write elsewhere")
    return path


def search_config(cpu: bool, backend: str = "auto") -> dict:
    """SessionConfig keywords of a driver's ``-c`` and backend."""
    return dict(backend=backend, device="cpu" if cpu else None)


def search_target(config: dict) -> str:
    """'<device>, backend=<backend>' of a driver's searches; raises
    RuntimeError without a card unless the CPU was asked for."""
    from ..ops.search import resolve_backend

    backend, device = resolve_backend(config.get("backend", "auto"),
                                      config.get("device"))
    return f"{device_label(device)}, backend={backend}"


def add_search_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run the plain engine on the CPU")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the outputs here (never eval_artifacts/)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_satabsearch_tpu_torch.eval.acceptance_eval",
        description="Ranking parity vs the reference CPU oracle, as a "
                    "markdown report")
    ap.add_argument("--restarts", type=int, nargs="+", default=[128, 4096])
    ap.add_argument("--backend", choices=("auto", "cuda", "torch"),
                    default="auto",
                    help="SA search: the CUDA kernel, or the plain PyTorch "
                         "engine (auto: the kernel, or with -c the plain "
                         "engine)")
    ap.add_argument("--reflog", default=None, metavar="DIR",
                    help="the reference's archived run logs "
                         f"({CPU_LOG}, {GPU_LOG}) for the noise floor")
    add_search_args(ap)
    args = ap.parse_args(argv)
    try:
        out_dir = check_out_dir(args.out) if args.out else None
        config = search_config(args.cpu, args.backend)
        where = search_target(config)
        rows = parity_rows(args.restarts, **config)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    floor = reference_floor(args.reflog)
    text = report(rows, floor, where)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "acceptance.md"), "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    v = verdict(rows, floor)
    return 1 if v is not None and not v[0] else 0


if __name__ == "__main__":
    sys.exit(main())
