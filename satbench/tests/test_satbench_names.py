"""Every name in BENCHMARK.json resolves to its files, and no module of
the benchmark loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re

import pytest

from satbench.cells import BENCH, ROOT, load_cell, metric_reader

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves(cell):
    c = load_cell(cell)
    assert cell == f"{c.config_name}.{c.traffic_name}"
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.checks["limits"]) >= {"score_mismatch", "stats_mismatch",
                                       "names_mismatch"}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(metric_reader(metric))


@pytest.mark.parametrize("config", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_every_config_file_is_under_the_paths(config):
    path = ROOT / config["file"]
    assert path.is_file()
    assert config["file"].split("/")[0] in BENCHMARK["paths"]
    body = json.loads(path.read_text())
    assert body["reduced"] == config["reduced"]
    assert body["db"]["entries"] > 0 and body["maxstart"] > 0


def test_names_and_keys_keep_to_the_contract():
    names = ([c["name"] for c in BENCHMARK["configs"]]
             + [w["name"] for w in BENCHMARK["workloads"]]
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
    for e in BENCHMARK["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imports_of(path)}
    assert not tops & {"jax", "jaxlib", "flax", "cuda_satabsearch_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports_of(path)}
    assert "cuda_satabsearch_tpu_torch" not in tops
