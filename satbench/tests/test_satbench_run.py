"""A run end to end on the CPU (the program's plain engine, a tiny cell,
past the look for a card): the result line, and faults planted in the
timed path that the check has to catch."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from satbench import check, deploy
from satbench import run as satrun
from satbench.cells import ROOT
from satbench.gen import Traffic
from satbench.program import Program

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(tiny_cell, name, tmp_path, trace=False, program=Program):
    return satrun.run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, trace,
                           device="cpu", cache=tmp_path, program=program)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["tiny.interactive", "tiny.survey"])
def test_the_result_line(tiny_cell, tmp_path, capsys, name, trace):
    out = run_tiny(tiny_cell, name, tmp_path, trace)
    satrun.emit(out, name)
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = tiny_cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert "setup_s" in line["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
    tail = std.err.strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k} {v['value']} limit {v['limit']}"
                    for k, v in line["checks"].items()]


def bare_run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "-m", "satbench.run",
                           "--workload", "astral586.interactive", "--seed",
                           "5", "--seconds", "1"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    res = bare_run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "satbench", tmp_path / "satbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    res = bare_run(tmp_path, {})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


class Faulty(Program):
    """The program with one fault planted where answers are produced."""

    fault = None

    def call(self, names, indices, *, loop, lorder, lsoln):
        if self.fault == "unchanged" and getattr(self, "first", None):
            # a step that returns its state unchanged: the first answers
            ans = super().call(names, indices, loop=loop, lorder=lorder,
                               lsoln=lsoln)
            for a in ans:
                a.scores, a.maps, a.stats = (self.first.scores,
                                             self.first.maps,
                                             self.first.stats)
            return ans
        if self.fault == "half" and len(names) > 1:
            # half of the list left out: its answers are the other half's
            half = (len(names) + 1) // 2
            ans = super().call(names, indices, loop=loop, lorder=lorder,
                               lsoln=lsoln)
            for k in range(half, len(ans)):
                src = ans[k - half]
                ans[k].scores, ans[k].maps, ans[k].stats = (
                    src.scores, src.maps, src.stats)
            return ans
        ans = super().call(names, indices, loop=loop, lorder=lorder,
                           lsoln=lsoln)
        for a in ans:
            if self.fault == "score":  # an answer altered where produced
                a.scores = a.scores.copy()
                a.scores[len(a.scores) // 2] += 1
            elif self.fault == "scatter":  # results out of file order
                a.scores = a.scores[::-1].copy()
            elif self.fault == "names":
                a.names = a.names[1:] + a.names[:1]
            elif self.fault == "stats":
                n2s, z, p = a.stats
                a.stats = (n2s, z + 1e-9, p)
            elif self.fault == "maps" and a.maps is not None:
                a.maps = a.maps.copy()
                a.maps[:, 0] = -1
        if self.fault == "unchanged":
            self.first = ans[0]
        return ans


@pytest.mark.parametrize("name,fault", [
    ("tiny.interactive", "score"), ("tiny.survey", "score"),
    ("tiny.interactive", "unchanged"), ("tiny.survey", "half"),
    ("tiny.survey", "scatter"), ("tiny.interactive", "names"),
    ("tiny.survey", "stats"), ("tiny.interactive", "maps")])
def test_a_fault_in_the_timed_path_is_not_correct(tiny_cell, tmp_path, name,
                                                   fault):
    prog = type("Planted", (Faulty,), {"fault": fault})
    out = run_tiny(tiny_cell, name, tmp_path, program=prog)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_the_control_in_the_programs_place_is_not_correct(tiny_cell,
                                                           tmp_path):
    """The reference in bfloat16, compared as the program's answers are:
    some number over its limit, while the program's are within them
    (every entry of the tiny DB as a query, at a seed where it shows)."""
    cell = tiny_cell("tiny.interactive")
    dep = deploy.prepare("tiny", cell.config, 0, tmp_path)
    prog = Program(dep.path, cell.config, 0, "cpu")
    answers = []
    for i, name in enumerate(dep.index.names):
        answers += prog.call([name], [i], loop="search", lorder=True,
                             lsoln=True)
    prog.close()
    numbers, info = check.check(answers, dep.index, per_query=12, seed=0,
                                seed32=0, maxstart=8, lorder=True,
                                lsoln=True, device="cpu", control=True)
    limits = cell.checks["limits"]
    assert all(numbers[k] <= limits[k] for k in numbers)
    assert any(info["control"][k] > limits[k] for k in info["control"])


def test_a_failing_call_is_counted_and_not_correct(tiny_cell, tmp_path):
    """The window's first call raises: counted as failed."""
    cell = tiny_cell("tiny.interactive")
    seed = 2 ** 31 + 3
    dep = deploy.prepare(cell.config_name, cell.config, seed, tmp_path)
    warm = len(Traffic(cell.traffic, dep.index.orders, seed).warm_calls())

    class Broken(Program):
        calls = 0

        def call(self, *a, **kw):
            self.calls += 1
            if self.calls == warm + 1:
                raise RuntimeError("planted")
            return super().call(*a, **kw)

    out = run_tiny(tiny_cell, "tiny.interactive", tmp_path, program=Broken)
    assert out["failed"] == 1 < out["attempted"]
    assert out["correct"] is False
    assert out["info"]["errors"] == ["RuntimeError('planted')"] * len(
        out["info"]["errors"])
