"""Fault injection for the pool executor — kill / delay workers by device id.

A `ChaosPlan` is installed ambiently (context manager, process-global) so the
public `KernelKMeans` API stays clean: CI runs the *unchanged* estimator under
an injected plan and asserts the fit still returns fault-free labels.

Semantics:

* `kill(worker, after_blocks=n)` — worker `worker`'s n+1-th block read raises
  `WorkerKilled`, and every later read by that worker fails immediately (a
  dead device stays dead across Lloyd iterations; the counter spans the whole
  fit, so "after_blocks=2" means die mid-first-iteration on any store with
  more than 2 blocks per worker).
* `delay(worker, seconds)` — every block read by that worker sleeps first: a
  straggler. Idle workers steal / speculatively re-execute its blocks.

The plan is consulted from the worker's read path (`before_read`), the exact
point where a real ingest fault — dead host, slow disk, network partition —
would surface.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from repro_torch import obs
from repro_torch.pool.tasks import WorkerKilled

_lock = threading.Lock()
_active: list["ChaosPlan | None"] = [None]


class ChaosPlan:
    """Declarative fault schedule keyed by worker (device) index."""

    def __init__(self):
        self._kills: dict[int, int] = {}     # worker -> die after N reads
        self._delays: dict[int, float] = {}  # worker -> seconds per read
        self._reads: dict[int, int] = {}
        self._lock = threading.Lock()

    def kill(self, worker: int, *, after_blocks: int = 0) -> "ChaosPlan":
        self._kills[int(worker)] = int(after_blocks)
        return self

    def delay(self, worker: int, seconds: float) -> "ChaosPlan":
        self._delays[int(worker)] = float(seconds)
        return self

    def before_read(self, worker: int) -> None:
        """Apply the plan to one block read by `worker`; called by executors."""
        with self._lock:
            kill_at = self._kills.get(worker)
            reads = self._reads.get(worker, 0)
            if kill_at is not None and reads >= kill_at:
                obs.counter("pool.chaos_kills").inc()
                raise WorkerKilled(
                    f"chaos: worker {worker} killed after {reads} block reads")
            self._reads[worker] = reads + 1
            sleep_s = self._delays.get(worker, 0.0)
        if sleep_s > 0.0:
            obs.counter("pool.chaos_delay_s").inc(sleep_s)
            time.sleep(sleep_s)

    def reset(self) -> None:
        """Forget read counts (a 'rebooted' worker fleet, same schedule)."""
        with self._lock:
            self._reads.clear()


def active() -> ChaosPlan | None:
    """The currently installed plan, if any."""
    with _lock:
        return _active[0]


@contextmanager
def inject(plan: ChaosPlan):
    """Install `plan` for the duration of the block; plans don't nest."""
    with _lock:
        if _active[0] is not None:
            raise RuntimeError("a ChaosPlan is already installed")
        _active[0] = plan
    try:
        yield plan
    finally:
        with _lock:
            _active[0] = None
