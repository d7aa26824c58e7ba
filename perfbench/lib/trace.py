"""The traced run's readings: host spans at the benchmark's own calls into
the program, and the device's activity from ``torch.profiler`` (CUDA
activity only, raw events summed by name: building an object an event
would take longer than the window).

A span is (name, start, end) on the host's ``perf_counter_ns``.  The
device's events are moved onto that clock by a marker: a one-element
fill launched right after a synchronize at a known host time.  Busy time
is the union of the device's event intervals inside the window, so
overlapping events count once; each idle gap is shared out among the
spans it overlaps, by what the host was doing meanwhile.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Tracer:
    def __init__(self, device):
        self.device = device
        self.spans: List[Tuple[str, int, int]] = []
        self.by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        self.busy_s = 0.0
        self.window_s = 0.0
        self.idle_by_span: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def span_seconds(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]

    @contextlib.contextmanager
    def window(self):
        """Trace the device over the body; the window is the body's time."""
        from torch.profiler import ProfilerActivity, profile
        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(self.device)
            t_mark = time.perf_counter_ns()
            marker.fill_(1.0)
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            yield self
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter_ns()
        self.window_s = (t1 - t0) / 1e9
        self._read(prof, t_mark, t0, t1)

    def _read(self, prof, t_mark: int, t0: int, t1: int) -> None:
        from torch.autograd import DeviceType
        events = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                events.append((e.start_ns(), e.duration_ns(), e.name()))
        self.reduce(events, t_mark, t0, t1)

    def reduce(self, events, t_mark: int, t0: int, t1: int) -> None:
        """Device events (start ns, duration ns, name) on the profiler's
        clock, the first of them the marker launched at host time t_mark
        -> per-name sums, busy time in [t0, t1], idle time by span."""
        if not events:
            return
        events = sorted(events)
        offset = events[0][0] - t_mark          # the marker comes first
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        intervals = []
        for start, dur, name in events[1:]:
            a, b = max(start - offset, t0), min(start - offset + dur, t1)
            row = self.by_name[name]
            row[0] += 1
            row[1] += dur / 1e9
            if b > a:
                intervals.append((a, b))
        busy, cur_a, cur_b = 0, None, None
        gaps = []
        prev_end = t0
        for a, b in sorted(intervals):
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > prev_end:
                    gaps.append((prev_end, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            prev_end = max(prev_end, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        if t1 > prev_end:
            gaps.append((prev_end, t1))
        self.busy_s = busy / 1e9
        for a, b in gaps:
            for name, ns in _split(spans, starts, a, b):
                self.idle_by_span[name] += ns / 1e9

    def device_seconds(self, *patterns: str) -> float:
        """Device seconds of the events whose names hold any pattern."""
        return sum(s for name, (_, s) in self.by_name.items()
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, (_, s) in top],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _split(spans, starts, a: int, b: int):
    """The host interval [a, b) cut by the (sequential) spans it overlaps:
    (span name, ns) pairs, what no span covers under its own name."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    covered = 0
    while i < len(spans) and spans[i][1] < b:
        name, s0, s1 = spans[i]
        ns = min(s1, b) - max(s0, a)
        if ns > 0:
            covered += ns
            yield name, ns
        i += 1
    if b - a > covered:
        yield "host between spans", b - a - covered
