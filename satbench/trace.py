"""The traced run: torch.profiler over the measured window, reduced to the
device's busy time, its activities by name and its idle gaps by what the
host was doing.

Spans are the benchmark's own, recorded on the host's wall clock
(``time.time_ns``) around its calls into the program (``satbench.call``
around a call, inside it ``satbench.resolve``, ``satbench.search`` and
``satbench.stats``).  The device's activities (kernels, copies, sets)
are the profiler's CUDA records, whose times the profiler gives on the
same Unix clock (within some tens of microseconds).  Only the CUDA
activity is traced: recording every host-side operator as well doubled
the host time of a 586-entry query.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

SPANS = ("satbench.stats", "satbench.search", "satbench.resolve",
         "satbench.call")  # innermost first


def short_name(name: str) -> str:
    """A device activity's name without its return type, namespace and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:80]


def overlap_ns(spans, starts, lo: int, hi: int) -> int:
    """Time of [lo, hi) covered by ``spans`` (sorted, disjoint [start,
    end) pairs whose starts are ``starts``)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0
    while i < len(spans) and spans[i][0] < hi:
        total += max(0, min(spans[i][1], hi) - max(spans[i][0], lo))
        i += 1
    return total


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


@dataclass
class TraceSummary:
    window_ns: tuple  # (start, end) of the traced window, profiler clock
    device: list  # [(start_ns, end_ns, name)] of the device's activities
    spans: dict = field(default_factory=dict)  # name -> [(start, end)]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self, match=None) -> float:
        """Seconds in which a device activity (whose name contains
        ``match``, if given) ran inside the window."""
        lo, hi = self.window_ns
        return union_ns([(s, e) for s, e, n in self.device
                         if match is None or match in n], lo, hi) / 1e9

    def top_ops(self, n: int = 10) -> list:
        total: dict[str, int] = {}
        for s, e, name in self.device:
            total[short_name(name)] = total.get(short_name(name), 0) + e - s
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window, split by what the host
        was doing meanwhile: in which of the benchmark's spans (the
        innermost), inside a call but outside them, or between calls."""
        lo, hi = self.window_ns
        starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        total = dict.fromkeys(SPANS + ("between calls",), 0)
        end = lo
        for s, e, _ in self.device + [(hi, hi, "")]:
            s = min(s, hi)
            if s > end:
                inner = 0
                for k in SPANS[:-1]:
                    t = overlap_ns(self.spans[k], starts[k], end, s)
                    total[k] += t
                    inner += t
                call = overlap_ns(self.spans["satbench.call"],
                                  starts["satbench.call"], end, s)
                total["satbench.call"] += call - inner
                total["between calls"] += (s - end) - call
            end = max(end, e)
            if end >= hi:
                break
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n] if v > 0]


class Tracer:
    """A profiler over the window when ``enabled``; ``span(name)`` records
    a host span (a no-op when not enabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.spans = {k: [] for k in SPANS}

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.time_ns()))

    def span(self, name: str):
        return self._span(name) if self.enabled else contextlib.nullcontext()

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if torch.cuda.is_available():
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary | None:
        if not self.enabled:
            return None
        device = []
        if self.prof is not None:
            from torch.autograd import DeviceType

            device = [(ev.start_ns(), ev.end_ns(), ev.name())
                      for ev in self.prof.profiler.kineto_results.events()
                      if ev.device_type() == DeviceType.CUDA]
        calls = self.spans["satbench.call"]
        window = (calls[0][0], calls[-1][1]) if calls else (0, 0)
        return TraceSummary(window_ns=window, device=sorted(device),
                            spans=self.spans)
