"""Fixtures of the benchmark's own tests: a tiny cell that runs on the
CPU (the program's plain engine), and the card where one is present."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from satbench.cells import BENCH, ROOT, load_cell

torch.set_num_threads(2)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """(benchmark dict, bench dir) of two tiny cells, ``tiny.interactive``
    and ``tiny.survey``: 12 synthetic entries, r = 8, the real traffic
    mixes, metrics and limits."""
    d = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic", "checks"):
        (d / sub).mkdir()
    with open(d / "configs" / "tiny.json", "w") as fh:
        json.dump({"db": {"kind": "astral_synthetic", "entries": 12},
                   "maxstart": 8, "maxiter": 100}, fh)
    for t in ("interactive", "survey"):
        shutil.copy(BENCH / "traffic" / f"{t}.json", d / "traffic")
    with open(BENCH / "checks" / "default.json") as fh:
        checks = json.load(fh)
    checks.update(sample_queries=3, sample_entries=6)
    with open(d / "checks" / "default.json", "w") as fh:
        json.dump(checks, fh)
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    bench["workloads"] = [
        {"name": "tiny.interactive", "config": "tiny",
         "traffic": "interactive", "chips": 1},
        {"name": "tiny.survey", "config": "tiny", "traffic": "survey",
         "chips": 1}]
    kinds = {w["name"]: w["traffic"] for w in json.load(
        open(ROOT / "BENCHMARK.json"))["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({"tiny." + ("interactive" if kinds[w]
                                                == "interactive"
                                                else "survey")
                                     for w in m["workloads"]})
    return bench, d


@pytest.fixture
def tiny_cell(tiny_bench):
    bench, d = tiny_bench
    return lambda name: load_cell(name, bench, d)


@pytest.fixture
def card():
    """The card's name; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)
