"""The reader of ``sa_move_us.list`` (satbench/metrics/sa_move_us.list.py)
on hand-built spans and device intervals: the union of the SA kernel's
intervals in the traced window over the sum, across the enqueue spans
that began in the window and carry CTA slots, of a chain's moves times
the waves of slots the launches fill; None without such spans, without
a trace or without the SA kernel."""

import types
from typing import NamedTuple

import pytest

pytest.importorskip("torch")

from cuda_satabsearch_tpu_torch import trace  # noqa: E402
from satbench.cells import metric_reader  # noqa: E402
from satbench.trace import TraceSummary  # noqa: E402

READ = metric_reader("sa_move_us.list")
WINDOW = (1_000, 100_000)


def S(name, a, b, sid, K=0, ctas=0, slots=0, moves=0, n1r=0):
    return trace.Span(name, a, b, sid, -1, 0, -1, K, 0, ctas, slots, moves,
                      n1r)


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


# SA kernels on two streams, overlapping; a copy between them
DEVICE = [(2_000, 40_000, "sa_plan_kernel<4, 1, false, 1>"),
          (2_500, 30_000, "sa_plan_kernel<1, 1, false, 1>"),
          (40_000, 41_000, "Memcpy DtoH"),
          (60_000, 90_000, "sa_plan_kernel<1, 1, true, 1>"),
          (90_000, 90_500, "sa_split_reduce"),
          (99_000, 120_000, "sa_plan_kernel<1, 1, false, 1>")]
# a 64-query tile of 14,291 entries unsplit (3,200 moves, 915,000 CTAs
# over 1,000 slots), one query split 2 ways (1,600 moves, 28,582 CTAs
# over 1,320), and one before the window, one off a card
SPANS = [
    S("kernel_search.enqueue", 500, 1_500, 0, 1, 14_291, 1_000, 3_200, 8),
    S("kernel_search.enqueue", 1_900, 2_100, 1, 64, 915_000, 1_000, 3_200,
      16),
    S("kernel_search.enqueue", 59_000, 59_500, 2, 1, 28_582, 1_320, 1_600,
      8),
    S("kernel_search.enqueue", 98_000, 98_500, 3, 1, 14_291, 0, 3_200, 8),
    S("kernel_search.drain", 41_000, 42_000, 4),
]


def run_of(device=DEVICE, traced=True):
    tr = TraceSummary(window_ns=WINDOW, device=device) if traced else None
    return types.SimpleNamespace(trace=tr,
                                 window=types.SimpleNamespace(queries=65))


@pytest.fixture
def spans(monkeypatch):
    def use(recorded):
        monkeypatch.setattr(trace, "spans", lambda: list(recorded))
        monkeypatch.setattr(trace, "dropped", lambda: 0)
    return use


def test_the_move_time_of_one_wave(spans):
    """Kernel union in the window: [2000, 40000), [60000, 90000) and
    [99000, 100000), 69,000 ns (the reduction is not the SA kernel);
    waves x moves: 915 x 3,200 + 28,582 / 1,320 x 1,600."""
    spans(SPANS)
    waves_moves = 915_000 / 1_000 * 3_200 + 28_582 / 1_320 * 1_600
    assert READ(run_of()) == pytest.approx(69.0 / waves_moves, rel=1e-12)


@pytest.mark.parametrize("case", ["no spans", "no figures", "no slots",
                                  "untraced", "no kernel"])
def test_nothing_to_read(spans, case):
    recorded, run = SPANS, run_of()
    if case == "no spans":
        recorded = []
    elif case == "no figures":  # a program without the launch figures
        recorded = [Bare(*s[:9]) for s in SPANS]
    elif case == "no slots":  # off a card
        recorded = [s._replace(cta_slots=0) for s in SPANS]
    elif case == "untraced":
        run = run_of(traced=False)
    else:
        run = run_of([d for d in DEVICE if "sa_plan_kernel" not in d[2]])
    spans(recorded)
    assert READ(run) is None
