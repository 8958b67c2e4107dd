"""Leased, reassignable block tasks: the master half of the pool control plane.

A `TaskPool` holds one task per block of a pass. Workers (one per device)
pull tasks with `acquire`, report liveness with heartbeats, and push results
with `complete`. The pool is the single synchronization point and encodes
every fault-tolerance rule of the subsystem:

* **Affinity**: tasks are seeded into per-worker deques by round-robin block
  id — exactly the placement the lockstep executor uses (`store.shard(d, D)`)
  — so a fault-free pool pass reads the same blocks on the same devices as
  lockstep.
* **Stealing**: an idle worker whose own deque is empty pops from the *back*
  of the fullest other deque (the blocks a straggler is furthest from
  reaching).
* **Leases + heartbeats**: every acquisition is a lease with a deadline.
  `heartbeat` records liveness (gap histogram `pool.heartbeat_gap_s`); a
  worker that stops heartbeating past the lease timeout forfeits its
  in-flight lease — any other worker's `acquire` scavenges expired leases
  back into circulation (`pool.lease_timeouts`, `pool.tasks_requeued`).
* **Failed-worker requeue**: `fail_worker` marks a worker dead, requeues its
  in-flight lease immediately (`pool.worker_deaths`), and leaves its deque in
  place for others to steal. If every worker dies with tasks outstanding, the
  first recorded error is raised to the driver.
* **Speculative backups**: when nothing is queued and nothing has expired, an
  idle worker re-executes the oldest still-outstanding lease of another
  worker (MapReduce's classic straggler mitigation, `pool.tasks_speculated`)
  rather than sitting idle behind a slow device.
* **Duplicate drop**: `complete` accepts the FIRST result per block id and
  drops re-executions (`pool.duplicates_dropped`). Since every execution of a
  block computes the same function of the same block and the same broadcast
  centroids, all copies are identical and first-wins is deterministic.

Determinism: results are keyed by task (block) id; `results()` returns them
in global block-id order, so the caller's merge is independent of which
worker ran what, in what order, with how many retries.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch import obs


class WorkerKilled(RuntimeError):
    """Raised inside a worker by the chaos harness to simulate its death."""


@dataclass
class Lease:
    task_id: int
    worker: int
    deadline: float
    acquired_at: float
    speculated: bool = False


@dataclass
class _WorkerState:
    queue: deque = field(default_factory=deque)
    dead: bool = False
    last_beat: float = 0.0
    error: BaseException | None = None


class TaskPool:
    """Central pool of `num_tasks` block tasks shared by `num_workers` workers.

    `lease_timeout` is the heartbeat enforcement horizon: a lease older than
    this is considered abandoned and handed to whoever asks next. `clock` is
    injectable for deterministic unit tests.
    """

    def __init__(self, num_tasks: int, num_workers: int, *,
                 lease_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        if num_workers < 1:
            raise ValueError("TaskPool needs at least one worker")
        self.num_tasks = int(num_tasks)
        self.num_workers = int(num_workers)
        self.lease_timeout = float(lease_timeout)
        self._clock = clock
        self._cv = threading.Condition()
        self._workers = [_WorkerState() for _ in range(self.num_workers)]
        now = clock()
        for w in self._workers:
            w.last_beat = now
        # Round-robin affinity: block i belongs to worker i % D, matching the
        # lockstep executor's `store.shard(d, D)` placement.
        for t in range(self.num_tasks):
            self._workers[t % self.num_workers].queue.append(t)
        self._leases: dict[int, list[Lease]] = {}  # task_id -> active leases
        self._results: dict[int, Any] = {}
        self._hb_gap = obs.histogram("pool.heartbeat_gap_s")

    # ------------------------------------------------------------------ state

    @property
    def done(self) -> bool:
        with self._cv:
            return len(self._results) == self.num_tasks

    def first_error(self) -> BaseException | None:
        with self._cv:
            for w in self._workers:
                if w.error is not None:
                    return w.error
        return None

    def wait(self) -> None:
        """Block until every task has a result, or no live worker remains.

        This — not joining worker threads — is how a pass ends: a straggler
        still sleeping inside a block read whose task was already re-executed
        elsewhere must NOT gate the pass (its eventual completion is dropped
        as a duplicate and its thread exits on the next acquire)."""
        with self._cv:
            while (len(self._results) != self.num_tasks
                   and not all(w.dead for w in self._workers)):
                self._cv.wait(timeout=0.05)

    def results(self) -> list[Any]:
        """All task results in global block-id order. Raises if incomplete."""
        with self._cv:
            if len(self._results) != self.num_tasks:
                missing = sorted(set(range(self.num_tasks)) - set(self._results))
                err = self.first_error()
                if err is not None:
                    raise err
                raise RuntimeError(
                    f"pool pass incomplete: {len(missing)} tasks unfinished "
                    f"(first missing block {missing[0] if missing else '?'})")
            return [self._results[t] for t in range(self.num_tasks)]

    # ------------------------------------------------------------- worker API

    def heartbeat(self, worker: int) -> None:
        with self._cv:
            self._beat_locked(worker)

    def _beat_locked(self, worker: int) -> None:
        now = self._clock()
        ws = self._workers[worker]
        self._hb_gap.observe(max(0.0, now - ws.last_beat))
        ws.last_beat = now

    def acquire(self, worker: int) -> int | None:
        """Lease the next task for `worker`; None once all results are in.

        Order of preference: own affinity deque, steal from the fullest other
        deque, scavenge an expired lease, speculatively back up the oldest
        outstanding lease. Blocks (briefly, re-checking) while other workers
        still hold fresh leases.
        """
        with self._cv:
            while True:
                self._beat_locked(worker)
                if len(self._results) == self.num_tasks:
                    return None
                ws = self._workers[worker]
                if ws.dead:
                    return None
                if ws.queue:
                    return self._lease_locked(ws.queue.popleft(), worker)
                victim = max(
                    (w for w in self._workers if w is not ws and w.queue),
                    key=lambda w: len(w.queue), default=None)
                if victim is not None:
                    obs.counter("pool.tasks_stolen").inc()
                    return self._lease_locked(victim.queue.pop(), worker)
                expired = self._expired_locked(worker)
                if expired is not None:
                    obs.counter("pool.lease_timeouts").inc()
                    obs.counter("pool.tasks_requeued").inc()
                    self._drop_lease_locked(expired)
                    return self._lease_locked(expired.task_id, worker)
                backup = self._speculate_locked(worker)
                if backup is not None:
                    obs.counter("pool.tasks_speculated").inc()
                    return self._lease_locked(backup, worker, speculated=True)
                # Nothing to run right now: other workers hold fresh leases
                # for every remaining task. Wait for a completion/failure.
                self._cv.wait(timeout=min(0.05, self.lease_timeout / 4))

    def complete(self, worker: int, task_id: int, result: Any) -> bool:
        """Accept `result` for `task_id`; False if a duplicate was dropped."""
        with self._cv:
            self._beat_locked(worker)
            self._retire_lease_locked(task_id, worker)
            if task_id in self._results:
                obs.counter("pool.duplicates_dropped").inc()
                self._cv.notify_all()
                return False
            self._results[task_id] = result
            obs.counter("pool.tasks_completed").inc()
            self._cv.notify_all()
            return True

    def fail_worker(self, worker: int, exc: BaseException) -> None:
        """Mark `worker` dead and requeue its in-flight leases immediately."""
        with self._cv:
            ws = self._workers[worker]
            if ws.dead:
                return
            ws.dead = True
            ws.error = exc
            obs.counter("pool.worker_deaths").inc()
            for task_id in list(self._leases):
                for lease in list(self._leases[task_id]):
                    if lease.worker == worker:
                        self._drop_lease_locked(lease)
                        if (task_id not in self._results
                                and not self._leases.get(task_id)):
                            obs.counter("pool.tasks_requeued").inc()
                            ws.queue.append(task_id)  # stays stealable
            self._cv.notify_all()

    # -------------------------------------------------------------- internals

    def _lease_locked(self, task_id: int, worker: int, *,
                      speculated: bool = False) -> int:
        now = self._clock()
        lease = Lease(task_id, worker, now + self.lease_timeout, now,
                      speculated=speculated)
        self._leases.setdefault(task_id, []).append(lease)
        obs.counter("pool.tasks_leased").inc()
        return task_id

    def _drop_lease_locked(self, lease: Lease) -> None:
        active = self._leases.get(lease.task_id, [])
        if lease in active:
            active.remove(lease)
        if not active:
            self._leases.pop(lease.task_id, None)

    def _retire_lease_locked(self, task_id: int, worker: int) -> None:
        for lease in list(self._leases.get(task_id, [])):
            if lease.worker == worker:
                self._drop_lease_locked(lease)

    def _expired_locked(self, worker: int) -> Lease | None:
        now = self._clock()
        best = None
        for leases in self._leases.values():
            for lease in leases:
                if lease.worker == worker or lease.task_id in self._results:
                    continue
                holder = self._workers[lease.worker]
                stale = max(lease.deadline,
                            holder.last_beat + self.lease_timeout)
                if now >= stale and (best is None
                                     or lease.acquired_at < best.acquired_at):
                    best = lease
        return best

    def _speculate_locked(self, worker: int) -> int | None:
        # Back up the OLDEST outstanding lease of another worker, but at most
        # two concurrent executions per task: one primary + one backup.
        best = None
        for task_id, leases in self._leases.items():
            if task_id in self._results or len(leases) >= 2:
                continue
            for lease in leases:
                if lease.worker == worker:
                    continue
                if best is None or lease.acquired_at < best.acquired_at:
                    best = lease
        return best.task_id if best is not None else None
