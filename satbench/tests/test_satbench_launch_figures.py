"""The readers of the SA launches' figures, ``sa_cta_fill.long`` and
``sa_move_us.long``, on hand-built spans and device intervals: the fill
is a mean of per-span shares capped at 100, the move time divides the
union of the SA kernel's intervals, and both read nothing from an
untraced run or from spans without the figures (a program that records
none)."""

from __future__ import annotations

import types
from typing import NamedTuple

import pytest

from cuda_satabsearch_tpu_torch import trace
from satbench.cells import metric_reader
from satbench.trace import TraceSummary

FILL = metric_reader("sa_cta_fill.long")
MOVE = metric_reader("sa_move_us.long")


def S(name, a, b, sid, ctas=0, slots=0, moves=0):
    return trace.Span(name, a, b, sid, -1, 0, -1, 1, 0, ctas, slots, moves)


class Bare(NamedTuple):
    """A span as a program without the launch figures records it."""

    name: str
    start_ns: int
    end_ns: int
    sid: int
    parent: int
    request: int
    tag: int
    queries: int
    nbytes: int


# window [1_000, 100_000); SA kernels overlap on two streams
DEVICE = [(2_000, 40_000, "sa_plan_kernel<4, 1>"),
          (2_500, 30_000, "sa_plan_kernel<1, 1>"),
          (40_000, 41_000, "Memcpy DtoH"),
          (60_000, 90_000, "sa_plan_kernel<1, 1>"),
          (99_000, 120_000, "sa_plan_kernel<4, 1>")]
SPANS = [
    S("kernel_search.enqueue", 500, 1_500, 0, 586, 1000, 3200),  # before
    S("kernel_search.enqueue", 1_900, 2_100, 1, 586, 1172, 3200),
    S("kernel_search.enqueue", 59_000, 59_500, 2, 2_000, 1000, 3200),
    S("kernel_search.enqueue", 98_000, 98_500, 3, 586, 586, 3200),
    S("kernel_search.drain", 41_000, 42_000, 4),
]


def run_of(spans, traced=True):
    tr = (TraceSummary(window_ns=(1_000, 100_000), device=DEVICE)
          if traced else None)
    return types.SimpleNamespace(trace=tr,
                                 window=types.SimpleNamespace(queries=3))


@pytest.fixture
def spans(monkeypatch):
    def use(recorded):
        monkeypatch.setattr(trace, "spans", lambda: list(recorded))
        monkeypatch.setattr(trace, "dropped", lambda: 0)
    return use


def test_fill_is_the_mean_share_of_the_windows_spans(spans):
    """586 of 1172 slots, 2000 CTAs over 1000 slots (capped: the card is
    full), 586 of 586; the span before the window is left out."""
    spans(SPANS)
    assert FILL(run_of(SPANS)) == pytest.approx((50.0 + 100.0 + 100.0) / 3,
                                                rel=1e-12)


def test_fill_never_passes_100(spans):
    over = [S("kernel_search.enqueue", 2_000, 3_000, k, 10 ** 6 + k, 7, 1)
            for k in range(5)]
    spans(over)
    assert FILL(run_of(over)) == 100.0


def test_move_time_divides_the_kernels_union(spans):
    """Kernel union in the window: [2000, 40000) with the overlapping
    launch inside it, [60000, 90000), [99000, 100000): 69,000 ns; three
    spans of 3,200 moves began in the window."""
    spans(SPANS)
    union_us = (38_000 + 30_000 + 1_000) / 1e3
    summed_us = (38_000 + 27_500 + 30_000 + 1_000) / 1e3
    got = MOVE(run_of(SPANS))
    assert got == pytest.approx(union_us / (3 * 3200), rel=1e-12)
    assert got != pytest.approx(summed_us / (3 * 3200), rel=1e-3)


@pytest.mark.parametrize("read", [FILL, MOVE], ids=["fill", "move"])
def test_nothing_to_read(spans, read):
    bare = [Bare(*s[:9]) for s in SPANS]
    spans(bare)
    assert read(run_of(bare)) is None  # a program without the figures
    spans([S(*s[:4]) for s in SPANS])
    assert read(run_of(SPANS)) is None  # figures never set
    spans(SPANS)
    assert read(run_of(SPANS, traced=False)) is None  # untraced
    spans([])
    assert read(run_of([])) is None
