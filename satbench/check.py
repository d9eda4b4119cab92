"""The comparison that decides ``correct``.

Inside the window a seeded reservoir keeps a sample of the answers the
timed path produced (``Sampler``), with the query of the most SSEs among
them.  Once the window has closed and the program's state is freed,
``compare`` draws from the seed, for each kept query, entries of the DB
(plus the program's top hits, the query's own entry and the widest
entries), and holds the program's answers for those pairs against the
plain reference (reference/sa.py), which parses the entries from the DB
file itself and derives every stream from (seed, query tag, entry
index).  Numbers compared:

* ``names_mismatch``: entries whose name in the program's results is not
  the file's name at that position (the scatter to file order);
* ``score_mismatch``: pairs whose raw score differs from the reference's;
* ``map_mismatch``: under LSOLN, pairs whose SSE map differs;
* ``stats_mismatch``: pairs whose (norm2, z, p) differ in any bit from
  the reference's own statistics of its own score.
"""

from __future__ import annotations

import time

import numpy as np

from .deploy import entropy
from .reference import sa
from .reference.stats import score_stats


class Sampler:
    """A seeded reservoir of ``k`` answers, plus the longest query."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(entropy(seed, 3))
        self.kept: list = []
        self.seen = 0
        self.longest = None

    def offer(self, answer) -> None:
        if self.seen < self.k:
            self.kept.append(self._keep(answer))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = self._keep(answer)
        self.seen += 1
        if self.longest is None or answer.order > self.longest.order:
            self.longest = self._keep(answer)

    @staticmethod
    def _keep(answer):
        answer.scores = np.array(answer.scores, copy=True)
        return answer

    def answers(self) -> list:
        out = list(self.kept)
        if self.longest is not None and all(a.tag != self.longest.tag
                                            for a in out):
            out.append(self.longest)
        return out


def draw_pairs(answers, orders: np.ndarray, per_query: int,
               seed: int) -> list[tuple]:
    """[(answer, entry index)]: for each answer, ``per_query`` entries
    drawn from the seed and its tag, its top 3 hits, its own entry and
    the DB's two widest entries."""
    E = len(orders)
    widest = [int(i) for i in np.argsort(-orders, kind="stable")[:2]]
    pairs = []
    for a in answers:
        rng = np.random.default_rng(entropy(seed, 4, a.tag))
        picks = set(int(i) for i in rng.choice(E, min(per_query, E),
                                               replace=False))
        picks.update(int(i) for i in
                     np.argsort(-a.scores, kind="stable")[:3])
        picks.add(a.query)
        picks.update(widest)
        pairs.extend((a, e) for e in sorted(picks))
    return pairs


def reference_answers(pairs, index, *, seed32: int, maxstart: int,
                      lorder: bool, lsoln: bool, device,
                      precision: str = "float32"):
    """(scores, maps) of the reference for ``pairs``."""
    cache: dict = {}

    def entry(i):
        if i not in cache:
            cache[i] = index.entry(i)
        return cache[i]

    return sa.search_pairs([entry(a.query) for a, _ in pairs],
                           [entry(e) for _, e in pairs],
                           [a.tag for a, _ in pairs], [e for _, e in pairs],
                           seed=seed32, maxstart=maxstart, lorder=lorder,
                           lsoln=lsoln, device=device, precision=precision)


def compare(pairs, index, scores, maps, got_scores, got_maps, got_stats,
            got_names, lsoln: bool) -> dict:
    """The numbers compared: the program's (or the control's) answers
    ``got_*`` per pair against the reference's ``scores`` and ``maps``."""
    orders = index.orders
    out = {"names_mismatch": 0, "score_mismatch": 0, "stats_mismatch": 0}
    if lsoln:
        out["map_mismatch"] = 0
    for names in got_names:
        out["names_mismatch"] = max(
            out["names_mismatch"],
            abs(len(names) - len(index.names))
            + sum(a != b for a, b in zip(names, index.names)))
    for b, (a, e) in enumerate(pairs):
        out["score_mismatch"] += int(got_scores[b] != scores[b])
        ref = score_stats(np.array([scores[b]]), a.order, orders[e])
        got = got_stats[b]
        out["stats_mismatch"] += int(any(
            np.float64(g).tobytes() != r[0].tobytes()
            for g, r in zip(got, ref)))
        if lsoln:
            out["map_mismatch"] += int(not np.array_equal(got_maps[b],
                                                          maps[b]))
    return out


def check(answers, index, *, per_query: int, seed: int, seed32: int,
          maxstart: int, lorder: bool, lsoln: bool, device,
          control: bool = False) -> tuple[dict, dict]:
    """(numbers, info): the program's numbers compared, and what was
    compared; with ``control`` also the control's numbers, the reference
    in bfloat16 put in the program's place (info["control"])."""
    t0 = time.perf_counter()
    pairs = draw_pairs(answers, index.orders, per_query, seed)
    kw = dict(seed32=seed32, maxstart=maxstart, lorder=lorder, lsoln=lsoln,
              device=device)
    scores, maps = reference_answers(pairs, index, **kw)
    got_scores = [int(a.scores[e]) for a, e in pairs]
    got_maps = [a.maps[e] for a, e in pairs] if lsoln else None
    got_stats = [tuple(s[e] for s in a.stats) for a, e in pairs]
    names = [a.names for a in answers]
    numbers = compare(pairs, index, scores, maps, got_scores, got_maps,
                      got_stats, names, lsoln)
    info = {"queries": len(answers), "pairs": len(pairs),
            "reference_s": time.perf_counter() - t0}
    if control:
        c_scores, c_maps = reference_answers(pairs, index,
                                             precision="bfloat16", **kw)
        c_stats = [tuple(s[0] for s in score_stats(
            np.array([c_scores[b]]), a.order, index.orders[e]))
            for b, (a, e) in enumerate(pairs)]
        info["control"] = compare(pairs, index, scores, maps, c_scores,
                                  c_maps, c_stats, [index.names], lsoln)
    return numbers, info
