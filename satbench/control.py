"""Readings that set the limits of the correctness check.

    python3 -m satbench.control --workload <cell> --seeds 11,12,13 \
        --seconds 2 [--out FILE]

For each seed, one run of the cell (a short window at the cell's own
load, its sample of answers checked as a run checks them) gives the
program's numbers, and the same pairs searched by the control give the
control's: the plain reference in bfloat16 (reference/sa.py) put in the
program's place.  The lower reading of a number is the largest the
program gives over the seeds; the upper reading the smallest the
control gives.  Prints one JSON line per seed and a summary line.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from .cells import load_cell
    from .run import run_cell

    ap = argparse.ArgumentParser(prog="python3 -m satbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("satbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, control=True)
        row = {"seed": seed, "correct": out["correct"],
               "attempted": out["attempted"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": out["info"]["check"]["control"],
               "pairs": out["info"]["check"]["pairs"],
               "reference_s": out["info"]["check"]["reference_s"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "lower": {k: max(r["program"][k] for r in rows)
                         for k in rows[0]["program"]},
               "upper": {k: min(r["control"][k] for r in rows)
                         for k in rows[0]["control"]},
               "control_failed_every_seed": all(
                   any(v > 0 for v in r["control"].values()) for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
