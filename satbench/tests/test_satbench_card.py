"""On the card (skipped elsewhere): a cell of BENCHMARK.json is correct,
and the control, at the cell's own size, is not, on three seeds."""

from __future__ import annotations

import pytest

from satbench import run as satrun
from satbench.cells import load_cell


@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_astral586_interactive_is_correct_and_its_control_is_not(card, seed):
    cell = load_cell("astral586.interactive")
    out = satrun.run_cell(cell, seed, 1.0, False, control=True)
    limits = cell.checks["limits"]
    assert out["correct"] is True, out["checks"]
    control = out["info"]["check"]["control"]
    assert any(control[k] > limits[k] for k in control), control
