"""Open-loop load generator: Poisson arrivals at a target QPS, with an
optional mid-run hot-swap trigger.

Open-loop is the honest way to measure a service: arrivals come from a
clock, not from the previous response, so a slow server accumulates queue
(or sheds) instead of silently slowing the client down — the
coordinated-omission trap a closed-loop replay falls into. Inter-arrival
gaps are exponential draws from a seeded generator (a Poisson process at
`qps`), submissions go through the tier's admission-controlled `submit`,
and sheds are counted rather than retried.

`swap_after` (a request index) triggers `registry.swap(model, swap_source)`
from a separate thread once that many requests have been submitted — the
warm+flip runs off the submit path, exactly like a production model push —
and the report records how long the swap took and how many responses each
model version answered, so a bench can assert the blip and the no-mixed-
model property.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.serving.admission import Shed
from repro_torch.serving.registry import ModelRegistry
from repro_torch.serving.server import ServeResponse, ServingTier


@dataclasses.dataclass
class LoadGenReport:
    """Everything one open-loop run measured."""

    target_qps: float
    offered: int  # arrivals generated
    admitted: int  # accepted by admission control
    shed: int  # typed rejections (offered == admitted + shed)
    errors: int  # responses with a dispatch error
    duration_s: float  # first arrival -> last response
    responses: list[ServeResponse]  # in delivery order
    by_version: dict[int, int]  # responses answered per model version
    swap_s: float | None = None  # wall time of the mid-run swap (None: no swap)
    swap_at: int | None = None  # request index that triggered it

    @property
    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    @property
    def rows_per_s(self) -> float:
        return len(self.responses) / self.duration_s if self.duration_s else 0.0

    def latency_ms(self, p: float) -> float:
        if not self.responses:
            return 0.0
        lats = np.sort(np.asarray([r.latency_s for r in self.responses]))
        idx = min(len(lats) - 1, max(0, int(round(p / 100.0 * (len(lats) - 1)))))
        return float(lats[idx] * 1e3)


def run_open_loop(
    tier: ServingTier,
    X: np.ndarray,
    *,
    qps: float,
    n_requests: int,
    model: str = "default",
    seed: int = 0,
    swap_after: int | None = None,
    swap_source=None,
    swap_d: int | None = None,
    registry: ModelRegistry | None = None,
    response_timeout_s: float = 30.0,
) -> LoadGenReport:
    """Drive `tier` with a Poisson arrival process; request i carries row
    `X[i % len(X)]` and request_id i. Returns once every admitted request
    has a response (or `response_timeout_s` expires, which raises)."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=n_requests)
    registry = registry if registry is not None else tier.registry

    responses: list[ServeResponse] = []
    lock = threading.Lock()
    done = threading.Event()
    admitted = 0

    def on_response(resp: ServeResponse) -> None:
        if prev_cb is not None:
            prev_cb(resp)  # keep any user-installed callback live mid-run
        with lock:
            responses.append(resp)
            if finished[0] and len(responses) >= admitted:
                done.set()

    finished = [False]
    prev_cb = tier.on_response
    tier.on_response = on_response  # chained above; restored at exit

    swap_s: float | None = None
    swap_thread: threading.Thread | None = None

    def do_swap():
        nonlocal swap_s
        t0 = time.perf_counter()
        registry.swap(model, swap_source, d=swap_d)
        swap_s = time.perf_counter() - t0

    shed = 0
    t_start = time.perf_counter()
    next_arrival = t_start
    try:
        for i in range(n_requests):
            next_arrival += gaps[i]
            now = time.perf_counter()
            if next_arrival > now:
                time.sleep(next_arrival - now)
            try:
                tier.submit(i, X[i % len(X)], model)
                with lock:
                    admitted += 1
            except Shed:
                shed += 1
            if swap_after is not None and i + 1 == swap_after:
                # off the submit path: warm+flip on its own thread, arrivals
                # keep flowing at the target rate meanwhile
                swap_thread = threading.Thread(target=do_swap, daemon=True)
                swap_thread.start()
        with lock:
            finished[0] = True
            if len(responses) >= admitted:
                done.set()
        if not done.wait(response_timeout_s):
            raise TimeoutError(
                f"loadgen: {len(responses)}/{admitted} responses after "
                f"{response_timeout_s}s"
            )
        if swap_thread is not None:
            swap_thread.join(response_timeout_s)
    finally:
        tier.on_response = prev_cb
    duration = time.perf_counter() - t_start

    by_version: dict[int, int] = {}
    errors = 0
    for r in responses:
        by_version[r.version] = by_version.get(r.version, 0) + 1
        if not r.ok:
            errors += 1
    return LoadGenReport(
        target_qps=qps, offered=n_requests, admitted=admitted, shed=shed,
        errors=errors, duration_s=duration, responses=responses,
        by_version=by_version, swap_s=swap_s, swap_at=swap_after,
    )
