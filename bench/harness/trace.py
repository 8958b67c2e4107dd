"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
over whole calls, read back from its Chrome trace into busy time, kernel time
by name, and the idle gaps named by the host spans open across them.

The profiler records the device only (the host's op events of a stream fit
run to hundreds of thousands and take minutes to export). Host and trace
clocks are tied by marks: before each traced call and after the last one,
with the card idle, the harness notes the host clock and launches a one-thread
spin kernel, whose start in the trace is that moment plus a launch latency.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict

#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The mark kernel's name in the trace (``torch.cuda._sleep``).
MARK = "spin_kernel"


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # first mark to last mark
    busy_s: float  # union of device activity inside the window
    kernel_s: float  # sum of kernel durations inside the window
    ops: dict  # device op name -> seconds
    gaps: list  # (host span name, seconds) of each idle gap


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _idle_gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of each stretch of [lo, hi] with no device activity."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def summarize(events: list, mark_times: list, spans: list) -> TraceSummary:
    """Read Chrome-trace ``events`` (ts and dur in microseconds): the window
    runs from the first mark to the last, ``mark_times`` are the host
    (perf_counter) seconds at each mark, and ``spans`` are (name, t0, t1)
    host spans that name each idle gap by the innermost one open across it."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(e["ts"] for e in device if MARK in e.get("name", ""))[-len(mark_times):]
    if len(marks) != len(mark_times) or len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} marks, the host made "
                           f"{len(mark_times)}")
    lo, hi = marks[0], marks[-1]
    offset = sum(t - m * 1e-6 for t, m in zip(mark_times, marks)) / len(marks)
    busy, ops, kernel_s = [], defaultdict(float), 0.0
    for e in device:
        if MARK in e.get("name", ""):
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b <= a:
            continue
        busy.append((a, b))
        ops[e.get("name", "?")] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_s += (b - a) * 1e-6
    named = []
    for a, b in _idle_gaps(busy, lo, hi):
        mid = 0.5 * (a + b) * 1e-6 + offset
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "harness"
        named.append((name, (b - a) * 1e-6))
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=_union(busy) * 1e-6,
                        kernel_s=kernel_s, ops=dict(ops), gaps=named)


class DeviceTrace:
    """``start()`` before the first traced call, ``mark()`` before each traced
    call, ``stop()`` after the last (a closing mark); then ``summary(spans)``."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self._device = device
        self._prof = None
        self.mark_times: list[float] = []

    def start(self) -> None:
        prof = self._torch.profiler
        self._prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self._prof.__enter__()
        # a first launch, not counted, so that the first mark finds the
        # device's activity records already being taken
        self._torch.cuda._sleep(1)
        self._torch.cuda.synchronize(self._device)

    def mark(self) -> None:
        self._torch.cuda.synchronize(self._device)
        self.mark_times.append(time.perf_counter())
        self._torch.cuda._sleep(1)

    def stop(self) -> None:
        self.mark()
        self._torch.cuda.synchronize(self._device)
        self._prof.__exit__(None, None, None)

    def summary(self, spans) -> TraceSummary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return summarize(events, self.mark_times, spans)
