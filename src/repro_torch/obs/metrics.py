"""Counters, gauges and histograms: the always-on numeric substrate.

Spans answer "where did the time go" when someone turns tracing on; metrics
answer "how much work happened" all the time — blocks read, bytes streamed
host-to-device, engine passes per label (the `PASS_COUNTS` successor), serve
latencies. Everything is registered in one process-wide `MetricsRegistry`
keyed by dotted names (`engine.blocks_read`, `serve.latency_ms`, ...), and
every mutation is lock-protected so the stream engine's producer threads
can bump the same counter without losing increments.

Measurement scoping is by snapshot, not by destructive reset: take
`snapshot()` before, `snapshot()` after, `delta()` the two — concurrent users
(nested fits, background serving) are unaffected. `reset(prefix)` exists for
tests that want an absolute zero (the `reset_pass_counts()` shim).
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import Iterator


class Counter:
    """Monotonic accumulator (float — byte counts overflow nothing)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v

    def _reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Gauge:
    """Last-set value, plus the high-water mark since the last reset
    (queue depths: the instantaneous value AND the worst case both matter)."""

    __slots__ = ("_v", "_hwm", "_lock")

    def __init__(self):
        self._v = 0.0
        self._hwm = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)
            if self._v > self._hwm:
                self._hwm = self._v

    @property
    def value(self) -> float:
        return self._v

    @property
    def hwm(self) -> float:
        return self._hwm

    def _reset(self) -> None:
        with self._lock:
            self._v = 0.0
            self._hwm = 0.0


class Histogram:
    """Rolling-window distribution (latencies, batch sizes): keeps the last
    `window` observations for percentiles plus lifetime count/sum/min/max."""

    __slots__ = ("window", "_ring", "_i", "_n", "_sum", "_min", "_max", "_lock")

    def __init__(self, window: int = 8192):
        self.window = int(window)
        self._ring: list[float] = []
        self._i = 0
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            if len(self._ring) < self.window:
                self._ring.append(v)
            else:
                self._ring[self._i] = v
                self._i = (self._i + 1) % self.window
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._n

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100], nearest-rank over the rolling window."""
        with self._lock:
            vals = sorted(self._ring)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    def stats(self) -> dict:
        with self._lock:
            vals = sorted(self._ring)
            n, s = self._n, self._sum
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0

        def pct(p):
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1,
                            max(0, int(round(p / 100.0 * (len(vals) - 1)))))]

        return {
            "count": n, "sum": s, "mean": (s / n if n else 0.0),
            "min": mn, "max": mx,
            "p50": pct(50), "p90": pct(90), "p99": pct(99),
        }

    def _reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._i = 0
            self._n = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")


class MetricsRegistry:
    """Name -> instrument. get-or-create accessors; a name keeps its kind for
    the life of the process (a Counter never silently becomes a Gauge)."""

    def __init__(self):
        self._items: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, **kw):
        with self._lock:
            item = self._items.get(name)
            if item is None:
                item = kind(**kw)
                self._items[name] = item
            elif not isinstance(item, kind):
                raise TypeError(
                    f"metric {name!r} is a {type(item).__name__}, "
                    f"not a {kind.__name__}"
                )
            return item

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 8192) -> Histogram:
        return self._get(name, Histogram, window=window)

    def snapshot(self, prefix: str = "") -> dict:
        """Point-in-time numeric view: counters/gauges -> float, histograms ->
        their stats dict. The input to `delta()` scoping."""
        with self._lock:
            items = list(self._items.items())
        out: dict = {}
        for name, item in items:
            if prefix and not name.startswith(prefix):
                continue
            if isinstance(item, Counter):
                out[name] = item.value
            elif isinstance(item, Gauge):
                out[name] = item.value
            else:
                out[name] = item.stats()
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero every instrument whose name starts with `prefix` (all of them
        for the empty prefix). Instances stay registered — held references
        keep working."""
        with self._lock:
            items = list(self._items.items())
        for name, item in items:
            if name.startswith(prefix):
                item._reset()


METRICS = MetricsRegistry()

# ---------------------------------------------------- module-level facade


def counter(name: str) -> Counter:
    return METRICS.counter(name)


def gauge(name: str) -> Gauge:
    return METRICS.gauge(name)


def histogram(name: str, window: int = 8192) -> Histogram:
    return METRICS.histogram(name, window=window)


def snapshot(prefix: str = "") -> dict:
    return METRICS.snapshot(prefix)


def reset_metrics(prefix: str = "") -> None:
    METRICS.reset(prefix)


def delta(before: dict, after: dict) -> dict:
    """after - before for every numeric metric (histogram dicts are passed
    through from `after` with their counts differenced)."""
    out: dict = {}
    for name, v in after.items():
        if isinstance(v, dict):
            prev = before.get(name, {})
            d = dict(v)
            d["count"] = v.get("count", 0) - prev.get("count", 0)
            d["sum"] = v.get("sum", 0.0) - prev.get("sum", 0.0)
            out[name] = d
        else:
            out[name] = v - before.get(name, 0.0)
    return out


@contextlib.contextmanager
def scoped(prefix: str = "") -> Iterator[dict]:
    """Snapshot-scoped measurement: yields a dict that is filled with the
    metric deltas accumulated inside the block on exit.

        with obs.scoped("engine.") as m:
            est.fit(store)
        m["engine.blocks_read"]
    """
    before = snapshot(prefix)
    out: dict = {}
    try:
        yield out
    finally:
        out.update(delta(before, snapshot(prefix)))


class MetricsView(Mapping):
    """A read-only dict over registered instruments under short names, each
    read through a cast: ``MetricsView(blocks_read=(counter, int))``. Modules
    that kept their telemetry in a plain dict before it moved into the
    registry expose one of these in its place, so old readers
    (``COUNTERS["blocks_read"]``, ``dict(COUNTERS)``) see the registry's
    values, in lockstep by construction."""

    def __init__(self, **instruments):
        self._items = instruments

    def __getitem__(self, key: str):
        inst, cast = self._items[key]
        return cast(inst.value)

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)
