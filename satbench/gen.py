"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the seed give the calls a run makes.

Parameters:

* ``loop``: ``"search"`` (one query per call, the interactive user) or
  ``"search_many"`` (a query list per call, the survey user); closed
  loop, one client: the next call starts when the last one returned;
* ``list_size``: queries per call of ``search_many`` (null: every DB
  entry);
* ``lorder``, ``lsoln``: the search's flags (LORDER, LSOLN).

Queries are DB entries, resolved by name from the resident DB as the
query-list mode resolves them.  They are drawn without replacement from
a seeded permutation of all entries, then from the next permutation,
so that every seed searches the same mix of sizes in another order.
Before the window, ``warm_calls`` searches one query of every round8
group of the DB (every query width the window can launch) and, for
lists, one whole list drawn apart from the window's.
"""

from __future__ import annotations

import numpy as np

from .deploy import entropy
from .reference.stream import round8


class Traffic:
    def __init__(self, params: dict, orders: np.ndarray, seed: int):
        self.loop = params["loop"]
        if self.loop not in ("search", "search_many"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self.lorder = bool(params["lorder"])
        self.lsoln = bool(params["lsoln"])
        self.orders = np.asarray(orders)
        n = len(self.orders)
        self.list_size = (1 if self.loop == "search"
                          else int(params.get("list_size") or n))
        if not 1 <= self.list_size <= n:
            raise ValueError(f"list_size {self.list_size} outside [1, {n}]")
        self.seed = seed
        self._rng = np.random.default_rng(entropy(seed, 2))
        self._perm = np.zeros(0, np.int64)
        self._at = 0

    def _draw(self, rng, n: int) -> list[int]:
        out = []
        while len(out) < n:
            if self._at == len(self._perm):
                self._perm, self._at = rng.permutation(len(self.orders)), 0
            take = self._perm[self._at:self._at + n - len(out)]
            self._at += len(take)
            out.extend(int(i) for i in take)
        return out

    def next_call(self) -> list[int]:
        """The entry indices of the next call's queries."""
        return self._draw(self._rng, self.list_size)

    def warm_calls(self) -> list[list[int]]:
        """The calls before the window: the first entry of every round8
        group, one per call, then (for lists) one list of its own."""
        firsts = {}
        for i, o in enumerate(self.orders):
            firsts.setdefault(round8(int(o)), i)
        calls = [[i] for _, i in sorted(firsts.items())]
        if self.loop == "search_many":
            rng = np.random.default_rng(entropy(self.seed, 5))
            calls.append([int(i) for i in rng.permutation(
                len(self.orders))[:self.list_size]])
        return calls
