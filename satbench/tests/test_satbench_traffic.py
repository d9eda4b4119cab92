"""Seeded traffic: the same seed draws the same calls, another seed
others, and the warm-up covers every query width the window can use."""

from __future__ import annotations

import json

import numpy as np
import pytest

from satbench import deploy
from satbench.cells import BENCH
from satbench.gen import Traffic, round8

ORDERS = np.array(deploy.index_file(str(BENCH / "data" / "astral586.ascii"))
                  .orders)
MIXES = ["interactive", "survey", "query200"]


def traffic(mix, seed):
    return Traffic(json.loads((BENCH / "traffic" / f"{mix}.json")
                              .read_text()), ORDERS, seed)


def calls(t, n):
    return [t.next_call() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_seeded_draws_repeat_and_differ(mix):
    seed = 2 ** 31 + 977  # wider than an int32, as the driver's are
    assert calls(traffic(mix, seed), 5) == calls(traffic(mix, seed), 5)
    assert calls(traffic(mix, seed), 5) != calls(traffic(mix, seed + 1), 5)
    assert traffic(mix, seed).warm_calls() == traffic(mix, seed).warm_calls()


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_draws_the_same_mix_of_sizes(mix):
    """A whole cycle of draws is every entry once, in another order."""
    t = traffic(mix, 5)
    n = len(ORDERS) // t.list_size * t.list_size
    drawn = [i for c in calls(t, n // t.list_size) for i in c]
    assert len(set(drawn)) == len(drawn) == n
    if n == len(ORDERS):
        assert sorted(drawn) == list(range(len(ORDERS)))


@pytest.mark.parametrize("mix", MIXES)
def test_warm_up_covers_every_round8_group(mix):
    t = traffic(mix, 11)
    warm = {round8(int(ORDERS[i])) for c in t.warm_calls() for i in c}
    assert warm == {round8(int(o)) for o in ORDERS}
    if t.loop == "search_many":
        assert max(len(c) for c in t.warm_calls()) == t.list_size


def test_the_synthetic_db_file_repeats_per_seed(tmp_path):
    config = {"db": {"kind": "astral_synthetic", "entries": 40}}
    a = deploy.prepare("syn", config, 7, tmp_path / "a")
    b = deploy.prepare("syn", config, 7, tmp_path / "b")
    c = deploy.prepare("syn", config, 8, tmp_path / "c")
    assert a.path.read_text() == b.path.read_text() != c.path.read_text()
    assert len(a.index.names) == 40
