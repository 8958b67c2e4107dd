"""The async serving tier: concurrent intake -> admission -> micro-batched
embed+assign over a multi-model registry.

The paper's payoff is that a fitted model is *servable*: assignment is one
cheap embed+argmin per batch (Property 4.4). This tier turns that
observation into a service shape:

    intake threads --submit()--> [admission bound] --> intake deque
                                                          |
                                  dispatcher thread  <----+
                                    |  routes to a per-model MicroBatcher
                                    |  flush = resolve(name) ONCE -> one
                                    |  embed launch + assign -> deliver futures

Any number of client threads call `submit` concurrently; each call either
raises the typed `Shed` (admission bound hit — load-shedding keeps admitted
p99 flat instead of letting the queue collapse) or returns a
`concurrent.futures.Future` that resolves to a `ServeResponse`. One
dispatcher thread owns every `MicroBatcher` (per served model name) and is
the only thread that serves batches on the device, so batch formation never
races model execution (a swap's warm-up launch runs on the swapping thread;
both use the device's default stream, which serialises them).

Swap consistency (the no-torn-batch argument): the batcher's
process closure resolves the registry entry exactly ONCE per flush, after
the batch is popped; the whole batch runs on that snapshot and every one of
its responses is tagged with that entry's version. A `registry.swap` flips
the pointer between flushes — in-flight batches finish on the old model, the
next flush picks up the new one, and no request is dropped or answered by a
mix of models.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from repro_torch import obs
from repro_torch.serving.admission import AdmissionController, Shed
from repro_torch.serving.registry import ModelRegistry, ServingModel
from repro_torch.stream.microbatch import MicroBatcher


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    request_id: Any
    x: np.ndarray
    model: str
    t_submit: float


@dataclasses.dataclass(frozen=True)
class ServeResponse:
    """One answered request: the label, which (model, version) produced it,
    and the end-to-end latency from admission to delivery."""

    request_id: Any
    label: int
    model: str
    version: int
    latency_s: float
    error: str | None = None  # set when the batch's dispatch failed

    @property
    def ok(self) -> bool:
        return self.error is None


class ServingTier:
    """Concurrent request intake over a `ModelRegistry`.

    Lifecycle: `start()` (or use as a context manager), any number of
    `submit(request_id, x, model=...)` calls from any threads, `stop()`
    (drains every pending batch; every admitted request gets a response).

    Example:
        >>> import numpy as np
        >>> from repro_torch.api import ModelRegistry, ServingTier
        >>> reg = ModelRegistry(max_batch=8)
        >>> _ = reg.register("echo", lambda X: np.zeros(len(X), np.int32), d=4)
        >>> with ServingTier(reg) as tier:
        ...     resp = tier.submit("r1", np.ones(4, np.float32), model="echo")
        >>> int(resp.result().label)
        0
    """

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        max_batch: int | None = None,
        max_delay_s: float = 0.002,
        max_inflight: int = 4096,
        clock: Callable[[], float] = time.perf_counter,
        on_response: Callable[[ServeResponse], None] | None = None,
    ):
        self.registry = registry
        self.max_batch = int(max_batch or registry.max_batch)
        if self.max_batch > registry.max_batch:
            raise ValueError(
                f"tier max_batch {self.max_batch} exceeds the registry's "
                f"max_batch {registry.max_batch}: registry closures copy every "
                "flush into a fixed (max_batch, d) device buffer, so a bigger "
                "flush would not fit it"
            )
        self.max_delay_s = float(max_delay_s)
        self.clock = clock
        self.on_response = on_response
        self.admission = AdmissionController(max_inflight)
        self._cv = threading.Condition()
        self._intake: collections.deque[tuple[ServeRequest, Future]] = (
            collections.deque()
        )
        self._batchers: dict[str, MicroBatcher] = {}  # dispatcher-thread only
        # per-model (entry, error) snapshot of the LAST flush — written by the
        # process closure, read by _deliver; both run inside the same
        # serialized flush on the dispatcher thread, so a plain dict is safe.
        self._last_flush: dict[str, tuple[ServingModel, str | None]] = {}
        self._running = False
        self._thread: threading.Thread | None = None
        self._e2e = obs.histogram("serve.e2e_latency_ms")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServingTier":
        if self._running:
            raise RuntimeError("serving tier already started")
        self._running = True
        self._thread = threading.Thread(
            target=self._run, name="serve-dispatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop intake and drain: every already-admitted request is flushed
        and answered before the dispatcher exits."""
        if self._thread is None:
            return
        with self._cv:
            self._running = False
            self._cv.notify()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "ServingTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- intake

    def submit(self, request_id: Any, x, model: str = "default") -> Future:
        """Thread-safe intake. Raises `KeyError` for an unregistered model
        name, `Shed` past the admission bound; otherwise returns a Future
        resolving to this request's `ServeResponse`."""
        if not self._running:
            raise RuntimeError("serving tier is not running (call start())")
        self.registry.resolve(model)  # unknown names fail fast, not in-batch
        self.admission.admit()  # raises Shed at the in-flight bound
        req = ServeRequest(
            request_id, np.asarray(x, np.float32), model, self.clock()
        )
        fut: Future = Future()
        with self._cv:
            if not self._running:  # raced stop(): nothing may enqueue after
                self.admission.release()  # the dispatcher's final drain lap
                raise RuntimeError("serving tier is stopping")
            self._intake.append((req, fut))
            self._cv.notify()
        return fut

    def submit_wait(self, request_id: Any, x, model: str = "default",
                    *, retry_s: float = 0.0005) -> Future:
        """Closed-loop convenience: block-and-retry instead of shedding
        (replay drivers want backpressure, open-loop clients want `submit`)."""
        while True:
            try:
                return self.submit(request_id, x, model)
            except Shed:
                time.sleep(retry_s)

    # ----------------------------------------------------------- dispatcher

    def _batcher(self, name: str) -> MicroBatcher:
        b = self._batchers.get(name)
        if b is None:
            b = MicroBatcher(
                self._process_for(name),
                max_batch=self.max_batch,
                max_delay_s=self.max_delay_s,
                clock=self.clock,
                on_result=self._deliver,
            )
            self._batchers[name] = b
        return b

    def _process_for(self, name: str):
        def process(X: np.ndarray) -> np.ndarray:
            entry = None
            try:
                # ONE snapshot per batch. Inside the try: the name may have
                # been evicted between submit's fast-fail and this flush, and
                # that KeyError must fail THIS batch, not kill the dispatcher
                # (which would strand every in-flight future, for all models).
                entry = self.registry.resolve(name)
                labels = entry.process(X)
                self._last_flush[name] = (entry, None)
                return labels
            except Exception as e:  # noqa: BLE001 — a bad batch must not
                # kill the dispatcher; its requests get error responses
                self._last_flush[name] = (entry, f"{type(e).__name__}: {e}")
                obs.counter("serve.errors").inc(X.shape[0])
                return np.full(X.shape[0], -1, np.int32)

        return process

    def _deliver(self, rid, label: int, _batcher_lat: float) -> None:
        req, fut = rid
        entry, err = self._last_flush[req.model]
        lat = self.clock() - req.t_submit
        resp = ServeResponse(
            request_id=req.request_id, label=int(label), model=req.model,
            version=entry.version if entry is not None else -1,
            latency_s=lat, error=err,
        )
        self.admission.release()
        self._e2e.observe(lat * 1e3)
        obs.counter(f"serve.model.{req.model}.served").inc()
        fut.set_result(resp)
        if self.on_response is not None:
            try:
                self.on_response(resp)
            except Exception:  # noqa: BLE001 — a user callback runs on the
                # dispatcher thread; its bugs must not stop the service
                obs.counter("serve.callback_errors").inc()

    def _deadline_in(self) -> float | None:
        """Seconds until the earliest batcher deadline (None: nothing
        pending anywhere)."""
        deadlines = [
            d for d in (b.next_deadline for b in self._batchers.values())
            if d is not None
        ]
        if not deadlines:
            return None
        return min(deadlines) - self.clock()

    def _run(self) -> None:
        obs.set_lane("serve.dispatch")
        while True:
            with self._cv:
                while not self._intake and self._running:
                    timeout = self._deadline_in()
                    if timeout is None:
                        self._cv.wait()
                    else:
                        if timeout > 0:
                            self._cv.wait(timeout)
                        break  # a deadline may be due: fall through to poll
                drained = list(self._intake)
                self._intake.clear()
                running = self._running
            for req, fut in drained:
                # may flush inline when a batch fills — that is the fast path
                self._batcher(req.model).submit((req, fut), req.x)
            for b in self._batchers.values():
                b.poll()
            if not running:
                for b in self._batchers.values():
                    b.drain()
                with self._cv:
                    if not self._intake:  # raced submits get one more lap
                        break


__all__ = [
    "AdmissionController",
    "ModelRegistry",
    "ServeRequest",
    "ServeResponse",
    "ServingModel",
    "ServingTier",
    "Shed",
]
