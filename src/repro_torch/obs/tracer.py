"""Thread-safe span tracer: where the time of a MapReduce fit actually goes.

The paper's decomposition only pays off when mapper ingest, device compute and
the per-iteration reduce actually overlap — and the only way to know is to
look. A `Span` is one timed region (`perf_counter` start + duration) on one
*lane*; lanes map 1:1 onto the threads doing the work (the driver, one
producer per device), so an exported trace renders in Perfetto with one row
per producer and the ingest-bound-vs-compute-bound question answers itself.

Disabled (the default) the tracer is near-free and allocation-free:
`span(...)` returns a module-level singleton whose __enter__/__exit__ are
empty — no object is created, no clock is read, no lock is taken. Enabling
costs two `perf_counter` reads and one locked list append per span; span
bodies (block fetch, H2D, a full engine pass) are orders of magnitude larger.

Usage:

    from repro_torch import obs
    obs.enable_tracing()
    with obs.span("pass.map_reduce", cat="pass", blocks=8):
        ...
    obs.write_trace("fit.trace.json")      # Chrome trace-event -> Perfetto
"""
from __future__ import annotations

import threading
import time
from typing import Any


class _NullSpan:
    """The disabled path: a shared, stateless, no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed region on one lane. Finalized (recorded) on __exit__."""

    __slots__ = ("name", "cat", "lane", "t0", "dur", "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str, lane: str,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.lane = lane
        self.attrs = attrs
        self.t0 = 0.0
        self.dur = 0.0

    def set(self, **attrs):
        """Attach/overwrite attributes mid-span (e.g. an iteration's inertia,
        known only after the reduce)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = time.perf_counter() - self.t0
        self._tracer._record(self)
        return False


class Tracer:
    """A span collector. One process-wide instance (`TRACER`) backs the
    module-level API; tests may build their own for isolation."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._local = threading.local()
        # Anchor: wall-clock epoch corresponding to perf_counter() == 0, so
        # exported timestamps are absolute (and comparable across processes).
        self._epoch = time.time() - time.perf_counter()

    # ----------------------------------------------------------- lifecycle

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # --------------------------------------------------------------- lanes

    def set_lane(self, lane: str) -> None:
        """Name the calling thread's lane (producers call this once at thread
        start; the driver defaults to "main")."""
        self._local.lane = lane

    def current_lane(self) -> str:
        lane = getattr(self._local, "lane", None)
        if lane is not None:
            return lane
        t = threading.current_thread()
        return "main" if t is threading.main_thread() else t.name

    # --------------------------------------------------------------- spans

    def span(self, name: str, *, cat: str = "span", lane: str | None = None,
             **attrs: Any):
        """Context manager timing one region. Near-free when disabled: the
        shared NULL_SPAN is returned without touching a clock or a lock."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, lane or self.current_lane(), attrs)

    def instant(self, name: str, *, cat: str = "mark", lane: str | None = None,
                **attrs: Any) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        s = Span(self, name, cat, lane or self.current_lane(), attrs)
        s.t0 = time.perf_counter()
        self._record(s)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        """Snapshot of the recorded spans (record order)."""
        with self._lock:
            return list(self._spans)

    def lanes(self) -> list[str]:
        """Distinct lanes touched by recorded spans, first-seen order."""
        seen: dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s.lane, None)
        return list(seen)


TRACER = Tracer()

# ---------------------------------------------------- module-level facade


def enable_tracing() -> None:
    TRACER.enable()


def disable_tracing() -> None:
    TRACER.disable()


def tracing_enabled() -> bool:
    return TRACER.enabled


def clear_trace() -> None:
    TRACER.clear()


def set_lane(lane: str) -> None:
    TRACER.set_lane(lane)


def span(name: str, *, cat: str = "span", lane: str | None = None,
         **attrs: Any):
    return TRACER.span(name, cat=cat, lane=lane, **attrs)


def instant(name: str, *, cat: str = "mark", lane: str | None = None,
            **attrs: Any) -> None:
    TRACER.instant(name, cat=cat, lane=lane, **attrs)
