"""Find a cell's pieces by the names BENCHMARK.json gives them."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent  # the checkout


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json metric entries that this cell reports
    per_layer: list
    checks: dict  # limits and sample sizes of the correctness check


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None,
              bench: Path = BENCH) -> Cell:
    """The cell ``name`` of BENCHMARK.json (or of ``benchmark``), with its
    configuration, traffic mix, metrics and check settings."""
    if benchmark is None:
        benchmark = read_json(bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    checks = read_json(bench / "checks" / "default.json")
    own = bench / "checks" / f"{name}.json"
    if own.is_file():
        checks.update(read_json(own))
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_json(bench / "configs" / f"{w['config']}.json"),
        traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in benchmark["per_layer"] if _reports(m, name)],
        checks=checks)


def metric_reader(name: str, bench: Path = BENCH):
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing to read it from."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "satbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
