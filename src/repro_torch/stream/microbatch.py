"""Request micro-batching for the online assignment service.

Single-row dispatches waste the device (one (1, d) embed per request); the
micro-batcher collects up to `max_batch` requests or waits at most
`max_delay_s` past the oldest pending request, then runs ONE embed+assign
dispatch for the whole batch. Responses are delivered in submission order
regardless of batching boundaries.

Delivery is callback-first: pass `on_result` and every response is pushed as
`(request_id, label, latency_s)` the moment its batch completes — nothing
accumulates, so a long-running service (repro_torch.serving) holds O(max_batch)
state no matter how many requests flow through. Without a callback the
batcher keeps its legacy replay log in `.completed` (what the closed-loop
CLI replay and the property tests read); `replay_log=N` bounds it to the
last N responses for services that want a tail sample without the callback.
`.batch_sizes` is always bounded (one 8192-entry ring, mirroring the
`serve.batch_size` histogram window).

The batcher is thread-safe: `submit` may be called from any number of intake
threads while flushes run — the pending-queue swap is lock-protected and
flushes are serialized, so no request is ever dropped or double-dispatched
and delivery order still follows queue (submission) order. It is also
clock-injectable so replay harnesses (and tests) can drive it with simulated
time.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch import obs

#: ring size of the always-bounded `.batch_sizes` log (matches the
#: serve.batch_size histogram window, so both views cover the same tail)
BATCH_LOG_WINDOW = 8192


@dataclass
class _Pending:
    request_id: Any
    x: np.ndarray
    t_submit: float
    t_done: float = field(default=0.0)
    label: int = field(default=-1)


class MicroBatcher:
    """Collects rows, flushes them through `process_fn` as one batch.

    process_fn: (B, d) float32 -> (B,) int labels (one device dispatch).
    on_result: optional per-response callback `(request_id, label,
    latency_seconds)`, invoked in submission order from the flushing thread.
    Without it, responses accumulate in `.completed` as
    (request_id, label, latency_seconds) tuples, in submission order —
    bounded to the last `replay_log` entries when given.
    """

    def __init__(
        self,
        process_fn: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 256,
        max_delay_s: float = 0.002,
        clock: Callable[[], float] = time.perf_counter,
        on_result: Callable[[Any, int, float], None] | None = None,
        replay_log: int | None = None,
    ):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self.process_fn = process_fn
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.clock = clock
        self.on_result = on_result
        self._queue: list[_Pending] = []
        # callback mode keeps no log unless one is explicitly bounded-opted-in;
        # legacy (no-callback) mode logs everything the old way, or the last
        # replay_log entries when bounded.
        self._log_completed = on_result is None or replay_log is not None
        self.completed: collections.deque[tuple[Any, int, float]] = (
            collections.deque(maxlen=replay_log)
        )
        self.batch_sizes: collections.deque[int] = (
            collections.deque(maxlen=BATCH_LOG_WINDOW)
        )
        # `_lock` guards the pending queue (submit append / flush swap);
        # `_flush_lock` serializes whole flushes so concurrent flushers can't
        # reorder delivery — batches pop FIFO and deliver before the next pop.
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        # Rolling service metrics (repro_torch.obs): per-request latency and
        # per-flush batch size as windowed histograms, live queue depth as a
        # gauge. Shared registry names, so any co-resident monitor sees them.
        self._lat = obs.histogram("serve.latency_ms")
        self._bs = obs.histogram("serve.batch_size")
        self._depth = obs.gauge("serve.queue_depth")

    def submit(self, request_id: Any, x) -> None:
        """Enqueue one request; flushes immediately when the batch fills.
        Safe to call from concurrent intake threads."""
        p = _Pending(request_id, np.asarray(x), self.clock())
        with self._lock:
            self._queue.append(p)
            depth = len(self._queue)
        self._depth.set(depth)
        if depth >= self.max_batch:
            # full batches only: a racing submitter that loses the flush lock
            # must not dispatch the next batch prematurely as a partial one
            self.flush(partial=False)

    @property
    def pending(self) -> int:
        """Number of queued, not-yet-flushed requests."""
        with self._lock:
            return len(self._queue)

    @property
    def next_deadline(self) -> float | None:
        """Absolute time the oldest pending request must flush by (None when
        nothing is pending) — open-loop drivers sleep until min(next arrival,
        this) so sparse traffic still honors max_delay_s."""
        with self._lock:
            if not self._queue:
                return None
            return self._queue[0].t_submit + self.max_delay_s

    def poll(self) -> None:
        """Deadline check: flush a partial batch whose oldest request has
        waited longer than max_delay_s."""
        with self._lock:
            due = bool(self._queue) and (
                self.clock() - self._queue[0].t_submit >= self.max_delay_s
            )
        if due:
            self.flush()

    def flush(self, *, partial: bool = True) -> None:
        """Dispatch everything pending, one `max_batch`-bounded batch at a
        time, in queue order. `partial=True` (the default, what deadline and
        drain paths use) dispatches a final short batch; `partial=False`
        only dispatches full batches (the submit-triggered path)."""
        with self._flush_lock:
            first = True
            while True:
                with self._lock:
                    n = len(self._queue)
                    if n == 0 or (n < self.max_batch and not (partial and first)):
                        break
                    batch = self._queue[: self.max_batch]
                    del self._queue[: self.max_batch]
                    depth = len(self._queue)
                first = False
                self._depth.set(depth)
                X = np.stack([p.x for p in batch]).astype(np.float32)
                labels = np.asarray(self.process_fn(X)).astype(np.int32)
                now = self.clock()
                for p, lab in zip(batch, labels):
                    lat = now - p.t_submit
                    self._lat.observe(lat * 1e3)
                    if self.on_result is not None:
                        self.on_result(p.request_id, int(lab), lat)
                    if self._log_completed:
                        self.completed.append((p.request_id, int(lab), lat))
                self.batch_sizes.append(len(batch))
                self._bs.observe(len(batch))

    def drain(self) -> None:
        """Flush until nothing is pending (end of request stream)."""
        while self.pending:
            self.flush()

    def drain_completed(self) -> list[tuple[Any, int, float]]:
        """Pop-and-return everything in the replay log (drain-based
        consumption: callers that poll instead of passing `on_result` can
        take responses away so the log never grows)."""
        out = []
        while True:
            try:
                out.append(self.completed.popleft())
            except IndexError:
                return out
