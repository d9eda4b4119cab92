"""Run one cell of the benchmark and print its result line.

    python3 -m satbench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (``setup_s``, from the start of this module to the first
timed call): the program's import, its session (DB load by the native
loader, start-up, upload) and a warm-up of every query width the cell
will launch; making the cell's DB file and the benchmark's own index of
it are the benchmark's work and are left out.  Then the window: calls
back to back, one client, for ``--seconds``; the call that crosses the
end is counted whole, and the window's wall ends with it.  With
``--trace 1`` the window runs under torch.profiler and the per-layer
metrics are printed instead of the end-to-end ones.  After the window
the program's state is freed and the sampled answers are held against
the plain reference (check.py).  Standard error ends with each number
compared beside its limit; standard output ends with one JSON line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before anything heavy is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .cells import BENCH  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / "cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(BENCH / "cache" / "torch_extensions"))

from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402

from . import check, deploy  # noqa: E402
from .cells import Cell, load_cell, metric_reader  # noqa: E402
from .gen import Traffic  # noqa: E402
from .program import Program  # noqa: E402
from .trace import Tracer  # noqa: E402

# the whole top-level names that must not be loaded in a run
FOREIGN = ("jax", "jaxlib", "flax", "cuda_satabsearch_tpu")


@dataclass
class Window:
    wall_s: float = 0.0
    calls: int = 0
    queries: int = 0
    failed: int = 0
    latencies_ms: list = field(default_factory=list)  # per call
    n1s: list = field(default_factory=list)  # per query answered
    sa_launches: int = 0
    errors: list = field(default_factory=list)


@dataclass
class Run:
    """What a run measured: the metric readers' input."""

    cell: Cell
    setup_s: float
    session: dict  # the program's load_ms, warmup_s, upload_ms
    window: Window
    nentries: int
    orders: object  # int32 [E], the DB's entry orders
    lsoln: bool
    kind: str  # the card's name
    trace: object = None  # trace.TraceSummary under --trace 1


def foreign_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def run_window(prog: Program, traffic: Traffic, names: list[str],
               seconds: float, sampler: check.Sampler, span) -> Window:
    w = Window()
    launches = prog.launches()
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        idx = traffic.next_call()
        c0 = time.perf_counter()
        try:
            with span("satbench.call"):
                answers = prog.call([names[i] for i in idx], idx,
                                    loop=traffic.loop, lorder=traffic.lorder,
                                    lsoln=traffic.lsoln)
        except Exception as exc:  # counted, reported, and the loop goes on
            answers = []
            w.failed += len(idx)
            if len(w.errors) < 3:
                w.errors.append(repr(exc))
        c1 = time.perf_counter()
        w.calls += 1
        w.queries += len(idx)
        w.latencies_ms.append((c1 - c0) * 1e3)
        for a in answers:
            sampler.offer(a)
            w.n1s.append(a.order)
        if c1 >= end:
            break
    w.wall_s = c1 - t0
    w.sa_launches = prog.launches() - launches
    return w


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", cache=deploy.CACHE, control: bool = False,
             program=Program) -> dict:
    """Run ``cell``; returns the result line's object, the numbers
    compared under "checks" and what the run compared and found under
    "info" (the control's numbers under info["check"]["control"] when
    ``control``)."""
    import torch

    dep = deploy.prepare(cell.config_name, cell.config, seed, cache)
    traffic = Traffic(cell.traffic, dep.index.orders, seed)
    names = dep.index.names
    seed32 = seed % 2 ** 31  # the program's seed: an int32
    tracer = Tracer(trace)
    t_session = time.perf_counter()
    prog = program(dep.path, cell.config, seed32, device, span=tracer.span)
    t_warm = time.perf_counter()
    for idx in traffic.warm_calls():
        prog.call([names[i] for i in idx], idx, loop=traffic.loop,
                  lorder=traffic.lorder, lsoln=traffic.lsoln)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - T_START - dep.made_s
    steps = {"before_session_s": t_session - T_START - dep.made_s,
             "session_s": t_warm - t_session, "warm_s": t_end - t_warm}
    sampler = check.Sampler(int(cell.checks["sample_queries"]), seed)
    with tracer:
        window = run_window(prog, traffic, names, seconds, sampler,
                            tracer.span)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = tracer.summary()
    session = prog.info()
    prog.close()

    numbers, info = check.check(
        sampler.answers(), dep.index,
        per_query=int(cell.checks["sample_entries"]), seed=seed,
        seed32=seed32, maxstart=int(cell.config["maxstart"]),
        lorder=traffic.lorder, lsoln=traffic.lsoln, device=device,
        control=control)
    limits = cell.checks["limits"]
    correct = (window.queries > 0 and window.failed == 0
               and all(numbers[k] <= limits[k] for k in numbers))

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(cell=cell, setup_s=setup_s, session=session, window=window,
              nentries=len(names), orders=dep.index.orders,
              lsoln=traffic.lsoln, kind=kind, trace=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips if cuda else 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": window.queries,
           "failed": window.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.top_ops(),
                            "idle_gaps": summary.idle_gaps()}
    lat = np.percentile(window.latencies_ms, [10, 50, 90, 99, 100])
    out["info"] = {"setup_data_s": dep.made_s, "setup": steps, "check": info,
                   "session": session, "calls": window.calls,
                   "call_ms_p10_50_90_99_100": lat.tolist(),
                   "errors": window.errors}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m satbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"satbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = foreign_modules()
    if found:
        print(f"satbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    emit(out, f"{args.workload} seed {args.seed}")
    return 0


def emit(out: dict, label: str) -> None:
    """Print what the run compared and found (standard error, ending with
    each number compared beside its limit) and the result line (the last
    line of standard output, its "checks" last)."""
    info = out.pop("info")
    print(f"# {label}: {json.dumps(info)}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
