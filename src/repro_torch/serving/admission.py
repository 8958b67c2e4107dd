"""Admission control: bounded in-flight depth with typed load shedding.

An open-loop overload (arrivals faster than the device can assign) must not
queue without bound — an unbounded queue turns a transient burst into
minutes of tail latency for EVERY later request (queue collapse). Instead
the tier bounds the number of admitted-but-unanswered requests; past the
bound, `admit()` raises the typed `Shed` rejection immediately, the caller
gets a cheap, honest "retry later", and the p99 of admitted requests stays
flat. `serve.admitted` / `serve.shed_total` count both outcomes and
`serve.inflight` gauges the live depth (with its high-water mark).
"""
from __future__ import annotations

import threading

from repro_torch import obs


class Shed(RuntimeError):
    """Typed rejection: the tier is at its in-flight bound. Carries the
    depth/limit so callers (and logs) can see how saturated the tier was.

    Example:
        >>> from repro_torch.api import Shed
        >>> try:
        ...     raise Shed(4096, 4096)
        ... except Shed as e:
        ...     e.inflight >= e.limit
        True
    """

    def __init__(self, inflight: int, limit: int):
        super().__init__(
            f"request shed: {inflight} requests in flight >= limit {limit}"
        )
        self.inflight = inflight
        self.limit = limit


class AdmissionController:
    """Counting semaphore with shed-instead-of-block semantics."""

    def __init__(self, max_inflight: int = 4096):
        if max_inflight <= 0:
            raise ValueError("max_inflight must be positive")
        self.max_inflight = int(max_inflight)
        self._n = 0
        self._lock = threading.Lock()
        self._admitted = obs.counter("serve.admitted")
        self._shed = obs.counter("serve.shed_total")
        self._depth = obs.gauge("serve.inflight")

    def admit(self) -> None:
        """Reserve one in-flight slot or raise `Shed` (never blocks)."""
        with self._lock:
            if self._n >= self.max_inflight:
                n = self._n
                self._shed.inc()
                raise Shed(n, self.max_inflight)
            self._n += 1
            n = self._n
        self._admitted.inc()
        self._depth.set(n)

    def release(self) -> None:
        """Return a slot (called once per delivered response)."""
        with self._lock:
            self._n -= 1
            n = self._n
        self._depth.set(n)

    @property
    def inflight(self) -> int:
        return self._n
