"""The port's online assignment service (`repro_torch.serving`,
`repro_torch.stream.microbatch`) against the JAX package's.

Ports of every case of tests/test_serving.py (registry lifecycle, swap
metrics, request identity, unknown models, the mid-swap consistency under
load, admission under saturation, a failing batch, evict with pending
requests, the max_batch guard, multi-model routing, the open-loop swap and
the chained callback, the four MicroBatcher cases, checkpointed artifacts),
of tests/test_stream.py's two MicroBatcher cases and of
tests/test_obs.py::test_microbatcher_feeds_serve_metrics; then the parity of
the served labels: one model fitted by the JAX package, saved, loaded into
both packages, and 600 rows served through each package's `make_process_fn`
at max_batch 64, labels equal exactly, for nystrom, sd, rff and
tensorsketch. Everything runs on the CPU.
"""
from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import gaussian_blobs as j_gaussian_blobs
from repro.distributed import checkpoint as jck
from repro.serving.registry import make_process_fn as j_make_process_fn
from repro_torch import obs
from repro_torch.distributed import checkpoint as ck
from repro_torch.serving import (
    ModelRegistry,
    ServingTier,
    Shed,
    make_process_fn,
    run_open_loop,
)
from repro_torch.stream.microbatch import MicroBatcher

MEMBERS = ["nystrom", "sd", "rff", "tensorsketch"]

# ------------------------------------------------------------- registry


def _ident(X):
    return X[:, 0].astype(np.int32)


def _ident_plus(offset):
    return lambda X: X[:, 0].astype(np.int32) + offset


def test_registry_lifecycle():
    reg = ModelRegistry(max_batch=8)
    e1 = reg.register("a", _ident, d=1)
    assert e1.version == 1 and reg.resolve("a") is e1
    assert "a" in reg and len(reg) == 1

    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", _ident, d=1)

    e2 = reg.swap("a", _ident_plus(10), d=1)
    assert e2.version == 2
    assert reg.resolve("a") is e2
    assert e1.process is not e2.process

    reg.register("b", _ident, d=1)
    assert reg.names() == ["a", "b"]

    reg.evict("b")
    with pytest.raises(KeyError, match="registered: \\['a'\\]"):
        reg.resolve("b")
    with pytest.raises(KeyError, match="no serving model"):
        reg.swap("missing", _ident, d=1)
    with pytest.raises(KeyError):
        reg.evict("missing")


def test_swap_counts_in_metrics():
    obs.reset_metrics("serve.")
    reg = ModelRegistry(max_batch=4)
    reg.register("m", _ident, d=1)
    reg.swap("m", _ident_plus(1), d=1)
    reg.swap("m", _ident_plus(2), d=1)
    snap = obs.snapshot("serve.")
    assert snap["serve.swaps"] == 2
    assert snap["serve.model.m.swaps"] == 2
    assert reg.resolve("m").version == 3


# ------------------------------------------------------------------ tier


def test_tier_serves_and_preserves_request_identity():
    reg = ModelRegistry(max_batch=16)
    reg.register("m", _ident, d=1)
    with ServingTier(reg, max_delay_s=0.001, max_inflight=256) as tier:
        futs = [tier.submit(i, np.full(1, i, np.float32), "m")
                for i in range(100)]
        out = [f.result(timeout=10) for f in futs]
    assert [r.label for r in out] == list(range(100))
    assert all(r.ok and r.version == 1 and r.model == "m" for r in out)
    assert all(r.latency_s >= 0 for r in out)


def test_tier_unknown_model_rejected_at_submit():
    reg = ModelRegistry(max_batch=4)
    reg.register("m", _ident, d=1)
    with ServingTier(reg) as tier:
        with pytest.raises(KeyError, match="registered: \\['m'\\]"):
            tier.submit(0, np.zeros(1, np.float32), "nope")
    with pytest.raises(RuntimeError, match="not running"):
        tier.submit(0, np.zeros(1, np.float32), "m")


def test_mid_swap_label_consistency_under_load():
    """THE swap acceptance property: a forced hot swap under concurrent load
    drops nothing, answers every request with exactly one of {old, new}
    model, and never serves a torn batch (versions non-decreasing in
    delivery order)."""
    obs.reset_metrics("serve.")
    reg = ModelRegistry(max_batch=32)
    reg.register("m", _ident, d=1)

    delivered = []
    dlock = threading.Lock()

    def on_response(resp):
        with dlock:
            delivered.append(resp)

    n_threads, per_thread = 4, 300
    tier = ServingTier(reg, max_delay_s=0.0005, max_inflight=10_000,
                       on_response=on_response).start()

    half = threading.Event()  # trips once half the pre-swap load is served

    def on_response_counting(resp):
        with dlock:
            delivered.append(resp)
            if len(delivered) >= (n_threads * per_thread) // 2:
                half.set()

    tier.on_response = on_response_counting

    def submitter(t):
        for i in range(per_thread):
            tier.submit((t, i), np.full(1, t * per_thread + i, np.float32), "m")
            time.sleep(0.0002)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    assert half.wait(timeout=30), "load never reached the half-way mark"
    reg.swap("m", _ident_plus(1_000_000), d=1)  # forced mid-run swap
    # requests submitted strictly after the flip MUST be served by v2
    post = [tier.submit(("post", i), np.full(1, i, np.float32), "m")
            for i in range(50)]
    for th in threads:
        th.join()
    post_out = [f.result(timeout=30) for f in post]
    tier.stop()

    total = n_threads * per_thread + len(post)
    assert len(delivered) == total, "dropped or duplicated responses"
    assert len({r.request_id for r in delivered}) == total

    for r in delivered:
        t_i = r.request_id
        if t_i[0] == "post":
            continue
        base = t_i[0] * per_thread + t_i[1]
        if r.version == 1:
            assert r.label == base, r
        else:
            assert r.version == 2 and r.label == base + 1_000_000, r
    assert all(r.version == 2 and r.label == i + 1_000_000
               for i, r in enumerate(post_out))

    versions = [r.version for r in delivered]
    assert versions == sorted(versions), "torn/interleaved model versions"
    assert {1, 2} <= set(versions), "swap did not land mid-run"
    assert obs.snapshot("serve.")["serve.swaps"] == 1


def test_admission_sheds_at_saturation_without_collapse():
    """Past the in-flight bound, submits shed with the typed rejection —
    and every ADMITTED request still completes with bounded latency."""
    obs.reset_metrics("serve.")
    reg = ModelRegistry(max_batch=8)

    def slow(X):
        time.sleep(0.005)  # saturate: service rate << offered rate
        return X[:, 0].astype(np.int32)

    reg.register("m", slow, d=1)
    tier = ServingTier(reg, max_delay_s=0.001, max_inflight=24).start()
    futs, shed = [], 0
    for i in range(400):  # flood far past the bound, no pacing
        try:
            futs.append(tier.submit(i, np.full(1, i, np.float32), "m"))
        except Shed as e:
            shed += 1
            assert e.limit == 24 and e.inflight >= 24
    out = [f.result(timeout=60) for f in futs]
    tier.stop()

    assert shed > 0, "saturation never shed"
    assert len(out) == 400 - shed, "an admitted request was dropped"
    assert all(r.ok for r in out)
    assert tier.admission.inflight == 0
    snap = obs.snapshot("serve.")
    assert snap["serve.shed_total"] == shed
    assert snap["serve.admitted"] == 400 - shed
    assert snap["serve.model.m.served"] == 400 - shed


def test_tier_survives_failing_batch():
    """A dispatch that raises fails its OWN batch (typed error responses)
    and the dispatcher keeps serving later requests."""
    obs.reset_metrics("serve.")
    reg = ModelRegistry(max_batch=4)
    state = {"boom": False}

    def flaky(X):
        if state["boom"]:
            raise RuntimeError("kaboom")
        return X[:, 0].astype(np.int32)

    reg.register("m", flaky, d=1)  # warm runs pre-failure
    state["boom"] = True
    with ServingTier(reg, max_delay_s=0.0005) as tier:
        bad = [tier.submit(i, np.full(1, i, np.float32), "m") for i in range(4)]
        bad_out = [f.result(timeout=10) for f in bad]
        state["boom"] = False
        good = [tier.submit(10 + i, np.full(1, 10 + i, np.float32), "m")
                for i in range(4)]
        good_out = [f.result(timeout=10) for f in good]
    assert all(not r.ok and "kaboom" in r.error and r.label == -1
               for r in bad_out)
    assert [r.label for r in good_out] == [10, 11, 12, 13]
    assert all(r.ok for r in good_out)
    assert obs.snapshot("serve.")["serve.errors"] == 4


def test_evict_with_pending_requests_fails_batch_not_dispatcher():
    """Evicting a model while requests for it sit queued (submit fast-fail
    passed, flush not yet run) must deliver typed error responses for THAT
    batch — not kill the dispatcher and strand every in-flight future."""
    obs.reset_metrics("serve.")
    reg = ModelRegistry(max_batch=64)
    reg.register("doomed", _ident, d=1)
    reg.register("other", _ident_plus(500), d=1)
    # max_batch 64 with a long max_delay: submits sit in the batcher until
    # the deadline flush, leaving a window to evict underneath them
    tier = ServingTier(reg, max_delay_s=0.1, max_inflight=256).start()
    try:
        doomed = [tier.submit(i, np.full(1, i, np.float32), "doomed")
                  for i in range(3)]
        other = [tier.submit(10 + i, np.full(1, i, np.float32), "other")
                 for i in range(2)]
        time.sleep(0.02)  # let the dispatcher batch them, pre-deadline
        reg.evict("doomed")

        doomed_out = [f.result(timeout=10) for f in doomed]  # must not hang
        assert all(not r.ok and "KeyError" in r.error and r.label == -1
                   and r.version == -1 for r in doomed_out)
        # the dispatcher survived: the other model's batch still serves
        other_out = [f.result(timeout=10) for f in other]
        assert [r.label for r in other_out] == [500, 501]
        assert all(r.ok for r in other_out)
        # and the tier keeps serving — including a re-registered name
        reg.register("doomed", _ident_plus(9), d=1)
        again = tier.submit(99, np.full(1, 1, np.float32), "doomed")
        assert again.result(timeout=10).label == 10
    finally:
        tier.stop()
    assert tier.admission.inflight == 0
    assert obs.snapshot("serve.")["serve.errors"] == 3


def test_tier_max_batch_cannot_exceed_registry():
    """Registry closures pad to the REGISTRY's max_batch; a tier flushing
    bigger batches would recompile per shape, so it is rejected up front."""
    reg = ModelRegistry(max_batch=8)
    with pytest.raises(ValueError, match="exceeds the registry's max_batch"):
        ServingTier(reg, max_batch=16)
    assert ServingTier(reg, max_batch=8).max_batch == 8
    assert ServingTier(reg).max_batch == 8


def test_multi_model_routing():
    """Several live models: requests route by name, each batch serves one."""
    reg = ModelRegistry(max_batch=8)
    reg.register("even", _ident, d=1)
    reg.register("odd", _ident_plus(100), d=1)
    with ServingTier(reg, max_delay_s=0.001) as tier:
        futs = [tier.submit(i, np.full(1, i, np.float32),
                            "even" if i % 2 == 0 else "odd")
                for i in range(60)]
        out = [f.result(timeout=10) for f in futs]
    for i, r in enumerate(out):
        assert r.label == (i if i % 2 == 0 else i + 100), (i, r)
        assert r.model == ("even" if i % 2 == 0 else "odd")


# --------------------------------------------------------------- loadgen


def test_open_loop_loadgen_with_swap():
    reg = ModelRegistry(max_batch=16)
    reg.register("default", _ident, d=1)
    tier = ServingTier(reg, max_delay_s=0.001, max_inflight=2048).start()
    X = np.arange(500, dtype=np.float32)[:, None]
    rep = run_open_loop(
        tier, X, qps=4000, n_requests=400, seed=3,
        swap_after=200, swap_source=_ident_plus(7000), swap_d=1,
    )
    tier.stop()
    assert rep.offered == 400
    assert rep.admitted + rep.shed == rep.offered
    assert len(rep.responses) == rep.admitted
    assert rep.errors == 0
    assert rep.swap_s is not None and rep.swap_s >= 0
    assert set(rep.by_version) <= {1, 2} and 2 in rep.by_version
    for r in rep.responses:
        want = r.request_id % 500 + (0 if r.version == 1 else 7000)
        assert r.label == want, (r, want)
    assert rep.latency_ms(99) >= rep.latency_ms(50) > 0
    assert rep.rows_per_s > 0


def test_open_loop_loadgen_chains_existing_callback():
    """run_open_loop composes with (not clobbers) a user-installed
    on_response, and restores it when the run finishes."""
    reg = ModelRegistry(max_batch=16)
    reg.register("default", _ident, d=1)
    seen = []
    tier = ServingTier(reg, max_delay_s=0.001, max_inflight=2048,
                       on_response=lambda r: seen.append(r.request_id)).start()
    prev = tier.on_response
    X = np.arange(50, dtype=np.float32)[:, None]
    rep = run_open_loop(tier, X, qps=5000, n_requests=50, seed=1)
    tier.stop()
    assert sorted(seen) == sorted(r.request_id for r in rep.responses)
    assert tier.on_response is prev


# ---------------------------------------------- MicroBatcher (satellites)


def test_microbatcher_concurrent_submitters_regression():
    """8 threads hammer submit while flushes run: exactly-once delivery and
    per-thread submission order survive (the queue-swap race regression)."""
    delivered = []
    dlock = threading.Lock()

    def on_result(rid, label, _lat):
        with dlock:
            delivered.append((rid, label))

    mb = MicroBatcher(lambda X: X[:, 0].astype(np.int32), max_batch=16,
                      max_delay_s=0.001, on_result=on_result)
    n_threads, per_thread = 8, 250

    def submitter(t):
        for i in range(per_thread):
            mb.submit((t, i), np.full(2, t * per_thread + i, np.float32))

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    mb.drain()

    total = n_threads * per_thread
    assert len(delivered) == total, "a racing flush dropped/duplicated work"
    assert len({rid for rid, _ in delivered}) == total
    # labels stay glued to their own request through any interleaving
    for (t, i), label in delivered:
        assert label == t * per_thread + i
    # per-thread delivery order == per-thread submission order
    for t in range(n_threads):
        seq = [rid[1] for rid, _ in delivered if rid[0] == t]
        assert seq == sorted(seq), f"thread {t} reordered"


def test_microbatcher_callback_mode_accumulates_nothing():
    got = []
    mb = MicroBatcher(lambda X: np.zeros(len(X), np.int32), max_batch=4,
                      on_result=lambda rid, lab, lat: got.append(rid))
    for i in range(100):
        mb.submit(i, np.zeros(2, np.float32))
    mb.drain()
    assert got == list(range(100))
    assert len(mb.completed) == 0, "callback mode must not grow a log"
    assert len(mb.batch_sizes) <= 8192


def test_microbatcher_bounded_replay_log():
    mb = MicroBatcher(lambda X: np.zeros(len(X), np.int32), max_batch=4,
                      on_result=lambda *a: None, replay_log=16)
    for i in range(100):
        mb.submit(i, np.zeros(2, np.float32))
    mb.drain()
    assert len(mb.completed) == 16  # the LAST 16, bounded
    assert [rid for rid, _, _ in mb.completed] == list(range(84, 100))
    drained = mb.drain_completed()
    assert [rid for rid, _, _ in drained] == list(range(84, 100))
    assert len(mb.completed) == 0


def test_microbatcher_drain_completed():
    mb = MicroBatcher(lambda X: np.zeros(len(X), np.int32), max_batch=4)
    for i in range(10):
        mb.submit(i, np.zeros(2, np.float32))
    mb.drain()
    out = mb.drain_completed()
    assert [rid for rid, _, _ in out] == list(range(10))
    assert len(mb.completed) == 0 and mb.drain_completed() == []


# ------------------------------------------- checkpoint-backed registry


@pytest.mark.parametrize("artifact", ["model", "sweep"])
def test_registry_serves_checkpointed_artifacts(tmp_path, artifact):
    """register from a checkpoint directory: a ClusterModel artifact loads
    directly, a SweepResult artifact serves its selected winner, and the
    tier's labels equal core.kkmeans.predict exactly."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.kkmeans import predict
    from repro_torch.data.synthetic import gaussian_blobs
    from repro_torch.distributed.checkpoint import load_any_model, save_sweep_result
    from repro_torch.sweep.result import SweepResult

    X, _ = gaussian_blobs(0, 400, 4, 3, separation=4.0, device="cpu")
    est = KernelKMeans(3, kernel="rbf", kernel_params={"gamma": 0.25},
                       l=24, m=16, iters=5, device="cpu")
    est.fit(X, seed=1)
    model = est.model_
    ckpt = tmp_path / "ck"
    if artifact == "model":
        est.save(ckpt)
    else:
        sweep = SweepResult(
            models=[[model]],
            inertia=np.asarray([[float(model.inertia)]], np.float32),
            labels=None, k_grid=(3,), restarts=1, backend="local",
            best_k_index=0, best_restart=0,
        )
        save_sweep_result(ckpt, sweep)
    loaded = load_any_model(ckpt, device="cpu")
    assert loaded.centroids.shape == model.centroids.shape

    reg = ModelRegistry(max_batch=32, device="cpu")
    reg.register("default", str(ckpt))
    X_req = X[:64].numpy()
    with ServingTier(reg, max_delay_s=0.001) as tier:
        futs = [tier.submit(i, X_req[i]) for i in range(64)]
        out = [f.result(timeout=30) for f in futs]
    ref = predict(X_req, model.params, model.centroids, device="cpu").numpy()
    assert [r.label for r in out] == [int(v) for v in ref]
    assert all(r.ok and r.version == 1 for r in out)


# --------------------------- tests/test_stream.py and tests/test_obs.py


def test_microbatcher_preserves_request_order():
    clock = [0.0]

    def process(X):
        return X[:, 0].astype(np.int32)  # identity on the payload

    mb = MicroBatcher(process, max_batch=16, max_delay_s=0.5, clock=lambda: clock[0])
    n = 103  # deliberately not a multiple of the batch size
    for i in range(n):
        mb.submit(i, np.full((3,), i, np.float32))
        clock[0] += 0.01
    mb.poll()  # nothing pending long enough yet? advance past the deadline:
    clock[0] += 1.0
    mb.poll()
    mb.drain()
    ids = [rid for rid, _, _ in mb.completed]
    labels = [lab for _, lab, _ in mb.completed]
    assert ids == list(range(n)), "responses must come back in submission order"
    assert labels == list(range(n)), "labels must map to their own request's row"
    assert all(s <= 16 for s in mb.batch_sizes)
    assert sum(mb.batch_sizes) == n


def test_microbatcher_deadline_flush():
    clock = [0.0]
    mb = MicroBatcher(lambda X: np.zeros(len(X), np.int32),
                      max_batch=64, max_delay_s=0.002, clock=lambda: clock[0])
    mb.submit("a", np.zeros(2, np.float32))
    mb.poll()
    assert not mb.completed, "deadline not reached: nothing should flush"
    clock[0] += 0.01
    mb.poll()
    assert [rid for rid, _, _ in mb.completed] == ["a"]


def test_microbatcher_feeds_serve_metrics():
    obs.reset_metrics("serve.")
    mb = MicroBatcher(lambda X: np.zeros(X.shape[0], np.int32), max_batch=4)
    for i in range(10):
        mb.submit(i, np.zeros(3, np.float32))
    mb.drain()
    snap = obs.snapshot("serve.")
    assert snap["serve.latency_ms"]["count"] == 10
    assert snap["serve.batch_size"]["count"] == 3  # 4 + 4 + 2
    assert snap["serve.batch_size"]["max"] == 4
    assert obs.gauge("serve.queue_depth").value == 0  # drained
    assert obs.gauge("serve.queue_depth").hwm >= 3


# ------------------------------------------------ parity with the reference


def _member_kwargs(method):
    if method == "tensorsketch":
        return dict(method=method, kernel="poly", kernel_params=dict(degree=2, coef0=1.0), m=32)
    if method == "rff":
        return dict(method=method, kernel=JKernel("rbf", gamma=0.05), m=16)
    return dict(method=method, l=48, m=32)


@pytest.fixture(scope="module")
def rows():
    X, _ = j_gaussian_blobs(jax.random.PRNGKey(0), 1112, 8, 4, separation=4.0)
    X = np.asarray(X)
    return X[:512], X[512:]  # (fit rows, the 600 served rows)


@pytest.fixture(scope="module")
def reference_checkpoints(rows, tmp_path_factory):
    """One local fit of each member by the JAX package, saved by it."""
    X, _ = rows
    root = tmp_path_factory.mktemp("reference_models")
    out = {}
    for method in MEMBERS:
        est = JKernelKMeans(4, iters=10, block_rows=128, backend="local",
                            **_member_kwargs(method)).fit(X, key=jax.random.PRNGKey(3))
        est.save(root / method)
        out[method] = root / method
    return out


def _serve(process, X, batch):
    return np.concatenate([np.asarray(process(X[lo:lo + batch])).astype(np.int32)
                           for lo in range(0, X.shape[0], batch)])


@pytest.mark.parametrize("method", MEMBERS)
def test_served_labels_equal_the_references(rows, reference_checkpoints, method):
    """Exact: the same checkpoint loaded by each package, the same 600 rows
    through each package's make_process_fn at max_batch 64 (the last
    micro-batch of 24 rows padded)."""
    _, X = rows
    jmodel = jck.load_any_model(reference_checkpoints[method])
    tmodel = ck.load_any_model(reference_checkpoints[method], device="cpu")
    want = _serve(j_make_process_fn(jmodel, max_batch=64), X, 64)
    got = _serve(make_process_fn(tmodel, max_batch=64, device="cpu"), X, 64)
    assert got.dtype == np.int32 and got.shape == (600,)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("method", MEMBERS)
def test_served_models_props_equal_the_references(reference_checkpoints, method):
    """The family properties of each member's params, through the
    checkpoint the reference wrote: props_of equal field by field."""
    import dataclasses

    from repro.embed import props_of as j_props_of
    from repro_torch.embed import props_of

    jmodel = jck.load_any_model(reference_checkpoints[method])
    tmodel = ck.load_any_model(reference_checkpoints[method], device="cpu")
    assert dataclasses.asdict(props_of(tmodel.params)) == \
        dataclasses.asdict(j_props_of(jmodel.params))


def test_process_fn_pads_with_zeros_and_rejects_a_larger_batch(rows, reference_checkpoints):
    """A short micro-batch after a full one is served as if the buffer held
    zeros past it: its labels equal a fresh closure's."""
    _, X = rows
    tmodel = ck.load_any_model(reference_checkpoints["nystrom"], device="cpu")
    reused = make_process_fn(tmodel, max_batch=64, device="cpu")
    reused(X[:64])
    fresh = make_process_fn(tmodel, max_batch=64, device="cpu")
    np.testing.assert_array_equal(reused(X[64:70]), fresh(X[64:70]))
    with pytest.raises(ValueError, match="exceeds max_batch 64"):
        reused(X[:65])


def test_process_fn_moves_the_model_once(rows, reference_checkpoints, monkeypatch):
    """The params and centroids move to the device when the closure is
    built, not per call."""
    from repro_torch.api.model import ClusterModel

    _, X = rows
    tmodel = ck.load_any_model(reference_checkpoints["nystrom"], device="cpu")
    moves = []
    original = ClusterModel.to
    monkeypatch.setattr(ClusterModel, "to", lambda self, dev: moves.append(dev) or
                        original(self, dev))
    process = make_process_fn(tmodel, max_batch=64, device="cpu")
    for lo in range(0, 192, 64):
        process(X[lo:lo + 64])
    assert moves == [torch.device("cpu")]


@pytest.mark.parametrize("module", ["admission", "registry", "server"])
def test_docstring_examples_run(module):
    """The serving modules' examples (written against repro_torch.api) run."""
    import doctest
    import importlib

    res = doctest.testmod(importlib.import_module(f"repro_torch.serving.{module}"))
    assert res.attempted > 0 and res.failed == 0
