"""The port's pool control plane (`repro_torch.pool`) against the JAX
package's, on the CPU: the ports of the 24 tests of tests/test_pool.py, the
pool and shard cases of tests/test_obs.py, and the TaskPool rules held
against the JAX package's TaskPool step by step.

Where the JAX package forces eight host devices in a subprocess
(tests/pool_checks.py), the port runs eight ``cpu`` shards in process. The
load-bearing claim: a chaos run (killed and delayed workers) returns labels,
centroids, inertia and trajectory bitwise equal to the fault-free pool run,
because the host merge is in global block-id order.
"""
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.pool import TaskPool as JTaskPool
from repro_torch import obs
from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import Kernel
from repro_torch.data.synthetic import gaussian_blobs_blocks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.pool import ChaosPlan, TaskPool, WorkerKilled, active, inject
from repro_torch.stream import BlockStore, ooc_lloyd
from repro_torch.stream.engine import map_reduce

D = 8


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _drain(pool, worker):
    """Acquire-and-complete until the pool hands this worker nothing more."""
    seen = []
    while (task := pool.acquire(worker)) is not None:
        seen.append(task)
        pool.complete(worker, task, f"w{worker}:t{task}")
    return seen


# ------------------------------------------------------------------ TaskPool


def test_pool_affinity_matches_lockstep_round_robin():
    pool = TaskPool(8, 2, clock=FakeClock())
    order0, order1 = [], []
    for _ in range(4):
        t0, t1 = pool.acquire(0), pool.acquire(1)
        order0.append(t0), order1.append(t1)
        pool.complete(0, t0, t0), pool.complete(1, t1, t1)
    assert order0 == [0, 2, 4, 6]  # block i seeded to worker i % D: lockstep's placement
    assert order1 == [1, 3, 5, 7]
    assert pool.acquire(0) is None and pool.done
    assert pool.results() == list(range(8))


def test_pool_results_ordered_and_incomplete_raises():
    pool = TaskPool(3, 1, clock=FakeClock())
    with pytest.raises(RuntimeError, match="incomplete"):
        pool.results()
    for task in (0, 1, 2):
        assert pool.acquire(0) == task
        pool.complete(0, task, f"r{task}")
    assert pool.results() == ["r0", "r1", "r2"]


def test_pool_steals_from_the_fullest_deque_back():
    pool = TaskPool(6, 3, clock=FakeClock())  # deques: [0,3] [1,4] [2,5]
    for task in (2, 5):
        assert pool.acquire(2) == task
        pool.complete(2, task, task)
    stolen = pool.acquire(2)  # the back of the fullest other deque
    assert stolen == 3
    pool.complete(2, stolen, stolen)
    assert pool.acquire(2) == 4  # worker 1's deque is now the fullest


def test_pool_lease_expiry_scavenged_after_heartbeat_silence():
    clk = FakeClock()
    pool = TaskPool(1, 3, lease_timeout=10.0, clock=clk)
    before = obs.snapshot("pool.")
    assert pool.acquire(0) == 0  # worker 0 leases the only task and stalls
    assert pool.acquire(1) == 0  # idle worker 1 speculates a backup first
    clk.advance(11.0)  # both leases now stale (no heartbeats)
    assert pool.acquire(2) == 0  # worker 2 scavenges the oldest expired lease
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.tasks_speculated"] == 1
    assert seen["pool.lease_timeouts"] == 1
    assert seen["pool.tasks_requeued"] == 1
    assert pool.complete(2, 0, "from-2") is True  # first completion wins
    assert pool.complete(0, 0, "from-0") is False
    assert obs.delta(before, obs.snapshot("pool."))["pool.duplicates_dropped"] == 1
    assert pool.results() == ["from-2"]


def test_pool_heartbeat_keeps_lease_alive():
    clk = FakeClock()
    pool = TaskPool(1, 2, lease_timeout=10.0, clock=clk)
    assert pool.acquire(0) == 0
    clk.advance(8.0)
    pool.heartbeat(0)  # alive: the deadline extends past the beat
    clk.advance(4.0)  # t=12 > the original deadline, but beat + timeout = 18
    before = obs.snapshot("pool.")
    assert pool.acquire(1) == 0  # a backup, not a scavenge
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.tasks_speculated"] == 1
    assert seen.get("pool.lease_timeouts", 0) == 0


def test_pool_failed_worker_requeues_for_survivor():
    pool = TaskPool(4, 2, clock=FakeClock())
    assert pool.acquire(0) == 0
    pool.fail_worker(0, RuntimeError("device lost"))
    assert pool.acquire(0) is None  # dead workers get nothing
    survivor_saw = _drain(pool, 1)
    assert sorted(survivor_saw) == [0, 1, 2, 3]
    assert len(pool.results()) == 4
    assert "device lost" in str(pool.first_error())


def test_pool_all_dead_raises_first_error():
    pool = TaskPool(2, 1, clock=FakeClock())
    pool.fail_worker(0, RuntimeError("lone worker down"))
    with pytest.raises(RuntimeError, match="lone worker down"):
        pool.results()


def test_pool_speculation_capped_at_two_executions():
    pool = TaskPool(1, 3, lease_timeout=1e9, clock=FakeClock())
    assert pool.acquire(0) == 0
    assert pool.acquire(1) == 0  # one backup allowed...
    got = []
    t = threading.Thread(target=lambda: got.append(pool.acquire(2)))
    t.start()  # ...a third execution is not: worker 2 waits
    t.join(timeout=0.3)
    assert t.is_alive()
    pool.complete(1, 0, "done")  # the completion releases the waiter with None
    t.join(timeout=5.0)
    assert not t.is_alive() and got == [None]


def _script(pool_cls, metrics):
    """One scripted schedule (leases, completions, a death, a steal, a late
    completion, then a drain) and what each call returned, with the pool
    counters it moved."""
    clk = FakeClock()
    before = metrics.snapshot("pool.")
    pool = pool_cls(9, 3, lease_timeout=5.0, clock=clk)
    log = [pool.acquire(w) for w in (0, 1, 2)]
    log.append(pool.complete(1, log[1], "a"))
    pool.fail_worker(2, RuntimeError("x"))
    clk.advance(6.0)
    for _ in range(3):  # its own deque, then a steal from the fullest
        task = pool.acquire(1)
        log += [task, pool.complete(1, task, task)]
    log.append(pool.complete(0, log[0], "late"))
    log += _drain(pool, 1)
    log.append(pool.results())
    seen = metrics.delta(before, metrics.snapshot("pool."))
    return log, {k: v for k, v in seen.items() if k != "pool.heartbeat_gap_s" and v}


def test_taskpool_schedule_equals_the_references():
    """The port's TaskPool is a copy of the JAX package's: one scripted
    schedule gives the same leases, completions and counters in both."""
    assert _script(TaskPool, obs) == _script(JTaskPool, jobs)


# --------------------------------------------------------------- chaos plans


def test_chaos_kill_counts_reads_across_the_whole_fit():
    plan = ChaosPlan().kill(1, after_blocks=2)
    plan.before_read(1), plan.before_read(1)  # two reads survive
    with pytest.raises(WorkerKilled):
        plan.before_read(1)
    with pytest.raises(WorkerKilled):  # dead stays dead
        plan.before_read(1)
    plan.before_read(0)  # other workers unaffected
    plan.reset()
    plan.before_read(1)  # a rebooted fleet counts afresh


def test_chaos_inject_is_exclusive_and_scoped():
    assert active() is None
    plan = ChaosPlan()
    with inject(plan):
        assert active() is plan
        with pytest.raises(RuntimeError, match="already installed"):
            with inject(ChaosPlan()):
                pass
    assert active() is None


# -------------------------------------------- prefetcher shutdown regression


def test_prefetcher_joins_producer_when_consumer_raises():
    """A map error mid-pass ends the pass and the producer thread exits,
    repeatedly, with prefetch=1 forcing the producer into a blocking put."""
    store = BlockStore.from_array(np.zeros((1024, 4), np.float32), 64)

    def boom(x):
        raise RuntimeError("map boom")

    for _ in range(20):
        with pytest.raises(RuntimeError, match="map boom"):
            map_reduce(store, boom, lambda a, b: b, None, prefetch=1, device="cpu")
    leaked = [t.name for t in threading.enumerate() if t.name.startswith("block-")]
    assert leaked == []


def test_prefetcher_joins_producer_on_store_error():
    bad = BlockStore.from_generator(
        lambda i: (_ for _ in ()).throw(RuntimeError("gen boom")), n=512, d=4, block_rows=64)
    with pytest.raises(RuntimeError, match="gen boom"):
        map_reduce(bad, lambda x: x, lambda a, b: b, None, prefetch=1, device="cpu")
    assert not [t for t in threading.enumerate() if t.name.startswith("block-")]


# ------------------------------------------------- pool scheduler, in-process


def _mesh():
    return make_host_mesh(data=D, model=1)


def _blobs():
    return gaussian_blobs_blocks(0, 1200, 8, 4, block_rows=128, separation=4.0)


def _est(backend, **kw):
    kw.setdefault("iters", 10)
    if backend != "stream_shard":
        kw.setdefault("device", "cpu")
    return KernelKMeans(4, method="rff", m=32, n_init=1, block_rows=128, backend=backend, **kw)


def test_pool_scheduler_matches_lockstep_and_stream():
    """scheduler="pool" is a scheduling policy, not another algorithm: the
    labels of the lockstep executor (inertia within rtol 1e-4), and the
    single-device stream fit bit for bit: the pool's host f32 merge adds the
    block partials in block order from zeros, as the one-device pass does."""
    store, _ = _blobs()
    stream = _est("stream").fit(store, seed=7)
    lockstep = _est("stream_shard", mesh=_mesh()).fit(store, seed=7)
    pooled = _est("stream_shard", mesh=_mesh(), scheduler="pool").fit(store, seed=7)
    np.testing.assert_array_equal(stream.labels_, lockstep.labels_)
    assert lockstep.inertia_ == pytest.approx(stream.inertia_, rel=1e-4)
    _same_fit(pooled, stream)


def test_pool_tasks_completed_accounts_every_block_exactly():
    """One accepted completion a block a pass: num_blocks x (iterations + the
    final assign pass)."""
    store, _ = _blobs()
    before = obs.snapshot("pool.")
    fit = _est("stream_shard", mesh=_mesh(), scheduler="pool").fit(store, seed=7)
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.tasks_completed"] == store.num_blocks * (fit.n_iter_ + 1)
    assert seen["pool.tasks_leased"] >= seen["pool.tasks_completed"]
    assert seen.get("pool.worker_deaths", 0) == 0
    assert seen["pool.heartbeat_gap_s"]["count"] > 0


def test_pool_every_worker_killed_raises_to_the_driver():
    store, _ = _blobs()
    plan = ChaosPlan()
    for w in range(D):
        plan.kill(w, after_blocks=0)
    with inject(plan), pytest.raises(WorkerKilled):
        _est("stream_shard", mesh=_mesh(), scheduler="pool").fit(store, seed=7)


def test_pool_scheduler_requires_devices():
    ystore = BlockStore.from_array(np.zeros((256, 32), np.float32), 128)
    init = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="needs devices="):
        ooc_lloyd(ystore, 4, discrepancy="l2", init=init, iters=2, scheduler="pool",
                  device="cpu")


def _same_fit(a, b):
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert a.inertia_ == b.inertia_ and a.n_iter_ == b.n_iter_
    assert torch.equal(a.model_.centroids, b.model_.centroids)
    assert a.fit_report_.inertia_trajectory == b.fit_report_.inertia_trajectory


def test_pool_chaos_fit_labels_identical_in_process():
    """The keystone at eight shards: a fit whose worker 0 dies after one
    block returns the fault-free pool fit bit for bit (labels, inertia,
    centroids, trajectory)."""
    store, _ = _blobs()
    est = _est("stream_shard", mesh=_mesh(), scheduler="pool")
    fault_free = est.fit(store, seed=7)
    fault_free = (fault_free.labels_.copy(), fault_free.inertia_,
                  fault_free.model_.centroids.clone(),
                  list(fault_free.fit_report_.inertia_trajectory))
    with inject(ChaosPlan().kill(0, after_blocks=1)):
        chaos = est.fit(store, seed=7)
    np.testing.assert_array_equal(fault_free[0], chaos.labels_)
    assert chaos.inertia_ == fault_free[1]
    assert torch.equal(chaos.model_.centroids, fault_free[2])
    assert chaos.fit_report_.inertia_trajectory == fault_free[3]


SCENARIOS = {
    "killed_1": lambda: ChaosPlan().kill(0, after_blocks=1),
    "killed_2": lambda: ChaosPlan().kill(0, after_blocks=1).kill(3, after_blocks=2),
    "straggler": lambda: ChaosPlan().delay(0, 0.02),
}


def test_pool_chaos_keystone_at_eight_shards():
    """tests/pool_checks.py's chaos keystone at eight shards (in process
    here: eight ``cpu`` shards need no forced devices): killing one and two
    workers mid-iteration, and stalling one into a straggler, each fit is
    bitwise the fault-free pool fit, which has the stream backend's labels;
    the fault-free run completes each block once a pass."""
    store, _ = _blobs()
    stream = _est("stream", iters=12).fit(store, seed=7)
    est = _est("stream_shard", iters=12, mesh=_mesh(), scheduler="pool")
    before = obs.snapshot("pool.")
    base = est.fit(store, seed=7)
    free = obs.delta(before, obs.snapshot("pool."))
    np.testing.assert_array_equal(base.labels_, stream.labels_)
    assert free["pool.tasks_completed"] == store.num_blocks * (base.n_iter_ + 1)
    deltas = {}
    for name, make in SCENARIOS.items():
        before = obs.snapshot("pool.")
        with inject(make()):
            chaos = _est("stream_shard", iters=12, mesh=_mesh(), scheduler="pool").fit(
                store, seed=7)
        deltas[name] = obs.delta(before, obs.snapshot("pool."))
        _same_fit(chaos, base)
    assert deltas["killed_1"]["pool.worker_deaths"] >= 1
    assert deltas["killed_2"]["pool.worker_deaths"] >= 2
    assert deltas["killed_2"]["pool.tasks_requeued"] >= 1
    assert deltas["straggler"]["pool.tasks_stolen"] >= 1


# ------------------------------------------------- mid-fit Lloyd checkpoints


def _flaky(store, fail_after):
    """A store whose get() raises once ``fail_after`` reads have been served:
    a mid-fit ingest crash at the seam a real one hits."""
    count, lock = [0], threading.Lock()

    def get(i):
        with lock:
            count[0] += 1
            if count[0] > fail_after:
                raise RuntimeError("simulated ingest crash")
        return store.get(i)

    return BlockStore(get, n=store.n, d=store.d, block_rows=store.block_rows)


def _assert_resume_identical(tmp_path, make_est, store, fail_after):
    from repro_torch.distributed.checkpoint import LLOYD_STATE_DIR, latest_step

    ref = make_est().fit(store, seed=7)
    with pytest.raises(RuntimeError, match="simulated ingest crash"):
        make_est().fit(_flaky(store, fail_after), seed=7, checkpoint_dir=tmp_path)
    assert latest_step(tmp_path / "restart_0" / LLOYD_STATE_DIR) >= 1
    before = obs.snapshot("pool.")
    resumed = make_est().fit(store, seed=7, checkpoint_dir=tmp_path)
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.ckpt_resumes"] >= 1
    np.testing.assert_array_equal(ref.labels_, resumed.labels_)
    assert resumed.n_iter_ == ref.n_iter_
    assert resumed.inertia_ == ref.inertia_
    return ref, resumed


def test_stream_fit_resumes_identical_after_midfit_crash(tmp_path):
    store, _ = _blobs()
    nb = store.num_blocks
    # the reservoir pass, iteration 1 and half of iteration 2
    _assert_resume_identical(tmp_path, lambda: _est("stream"), store,
                             fail_after=2 * nb + nb // 2)


def test_pool_stream_shard_fit_resumes_identical_after_midfit_crash(tmp_path):
    store, _ = _blobs()
    nb = store.num_blocks
    # Speculative backups re-read blocks, so a pool pass may read up to 2 nb:
    # a 3 nb + 2 budget checkpoints iteration 1 before the crash lands.
    _assert_resume_identical(
        tmp_path, lambda: _est("stream_shard", mesh=_mesh(), scheduler="pool"), store,
        fail_after=3 * nb + 2)


def test_minibatch_fit_resumes_identical_after_midfit_crash(tmp_path):
    store, _ = _blobs()
    nb = store.num_blocks
    _assert_resume_identical(tmp_path, lambda: _est("minibatch", decay=0.9, epochs=3), store,
                             fail_after=2 * nb + nb // 2)


def test_lloyd_checkpoint_ignores_mismatched_fingerprint(tmp_path):
    """A checkpoint of another fit (other k) is not adopted: the refit runs
    from scratch and matches."""
    store, _ = _blobs()
    KernelKMeans(3, method="rff", m=32, n_init=1, iters=4, block_rows=128, backend="stream",
                 device="cpu").fit(store, seed=7, checkpoint_dir=tmp_path)
    ref = _est("stream").fit(store, seed=7)
    refit = _est("stream").fit(store, seed=7, checkpoint_dir=tmp_path)
    np.testing.assert_array_equal(ref.labels_, refit.labels_)
    assert refit.n_iter_ == ref.n_iter_


# ----------------------------------------------------------- elastic restore


def test_elastic_restores_cluster_model_and_sweep_result(tmp_path):
    from repro_torch.distributed.checkpoint import save_cluster_model
    from repro_torch.launch.elastic import restore_cluster_model, restore_sweep_result

    store, _ = _blobs()
    est = _est("stream").fit(store, seed=7)
    save_cluster_model(tmp_path / "model", est.model_)
    loaded = restore_cluster_model(tmp_path / "model", device="cpu")
    assert torch.equal(loaded.centroids, est.model_.centroids)
    assert float(loaded.inertia) == float(est.model_.inertia)
    assert loaded.meta.backend == "stream"
    result = _est("stream").sweep(store, k_grid=[3, 4], restarts=1, seed=7,
                                  checkpoint_dir=tmp_path / "sweep")
    sweep = restore_sweep_result(tmp_path / "sweep", device="cpu")
    assert sweep.k_grid == result.k_grid
    assert (sweep.best_k_index, sweep.best_restart) == (result.best_k_index,
                                                        result.best_restart)


def test_elastic_lloyd_resume_counts_device_count_changes(tmp_path):
    """A Lloyd state saved by eight workers resumes on three as an elastic
    resume; on eight as a plain one; another fingerprint is not adopted. The
    sharded drivers save with their shard count."""
    from repro_torch.distributed.checkpoint import lloyd_fingerprint, save_lloyd_state
    from repro_torch.launch.elastic import resume_lloyd_state

    init = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    fp = lloyd_fingerprint(kind="ooc", n=100, d=5, k=4, m=3, init=init)
    save_lloyd_state(tmp_path, step=2, centroids=init, labels=np.zeros(100, np.int32),
                     trajectory=[9.0, 8.0], shifts=[0.5, 0.25], changed=True,
                     fingerprint=fp, devices_used=8)
    before = obs.snapshot("pool.")
    state = resume_lloyd_state(tmp_path, fingerprint=fp, devices_used=3)
    seen = obs.delta(before, obs.snapshot("pool."))
    assert state is not None and state["step"] == 2
    assert state["devices_used"] == 8
    assert seen["pool.ckpt_resumes"] == 1
    assert seen["pool.elastic_resumes"] == 1
    before = obs.snapshot("pool.")
    assert resume_lloyd_state(tmp_path, fingerprint=fp, devices_used=8)
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.ckpt_resumes"] == 1
    assert seen.get("pool.elastic_resumes", 0) == 0
    other = lloyd_fingerprint(kind="ooc", n=100, d=5, k=5, m=3, init=init)
    assert resume_lloyd_state(tmp_path, fingerprint=other) is None


def test_sharded_fit_saves_its_shard_count_and_resumes_elastically(tmp_path):
    """An 8-shard fit saves ``devices_used=8``; its refit on four shards from
    the same directory adopts the state as an elastic resume and reaches the
    same labels."""
    from repro_torch.distributed.checkpoint import LLOYD_STATE_DIR, latest_step

    store, _ = _blobs()
    ref = _est("stream_shard", mesh=_mesh()).fit(store, seed=7, checkpoint_dir=tmp_path)
    before = obs.snapshot("pool.")
    four = _est("stream_shard", mesh=make_host_mesh(data=4, model=1)).fit(
        store, seed=7, checkpoint_dir=tmp_path)
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.elastic_resumes"] == 1
    np.testing.assert_array_equal(four.labels_, ref.labels_)
    assert four.n_iter_ == ref.n_iter_
    assert latest_step(tmp_path / "restart_0" / LLOYD_STATE_DIR) == ref.n_iter_


# ------------------------------------------------------------ fit reports


def _fit(backend, **kw):
    X = gaussian_blobs_blocks(0, 1024, 8, 3, block_rows=256)[0]
    if backend not in ("stream_shard", "shard_map"):
        kw.setdefault("device", "cpu")
    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), method="rff", m=32,
                       backend=backend, iters=5, n_init=1, random_state=7, **kw)
    est.fit(X, seed=7)
    return est


@pytest.mark.parametrize("backend", ["stream_shard", "shard_map"])
def test_every_backend_returns_populated_fit_report(backend):
    """tests/test_obs.py's cases for the two sharded backends."""
    est = _fit(backend, mesh=make_host_mesh(data=4, model=1))
    r = est.fit_report_
    assert isinstance(r, obs.FitReport)
    assert r.backend == backend
    assert r.iters >= 1 and r.rows_seen > 0
    assert len(r.inertia_trajectory) == r.iters + 1
    assert r.inertia_trajectory[-1] == pytest.approx(est.inertia_, rel=1e-6)
    assert set(r.phases) >= {"reservoir", "embed_fit", "seed", "lloyd"}


def test_pool_scheduler_fit_report_accounts_blocks():
    """The pool's workers bump the lockstep producers' engine counters, so the
    per-shard breakdown sums to blocks_read exactly (stale workers drained
    before the fit returns), and the fault-free identity tasks_completed ==
    blocks x (iters + 1) holds."""
    store = gaussian_blobs_blocks(0, 1024, 8, 3, block_rows=256)[0]
    before = obs.snapshot("pool.")
    est = _fit("stream_shard", scheduler="pool", mesh=make_host_mesh(data=4, model=1))
    seen = obs.delta(before, obs.snapshot("pool."))
    r = est.fit_report_
    assert r.blocks_read > 0 and r.bytes_h2d > 0
    assert sum(r.per_device_blocks.values()) == r.blocks_read
    assert {f"cpu/{w}" for w in range(4)} <= set(r.per_device_blocks)
    assert r.inertia_trajectory[-1] == pytest.approx(est.inertia_, rel=1e-6)
    assert seen["pool.tasks_completed"] == store.num_blocks * (est.n_iter_ + 1)


def test_exact_backends_report_identical_trajectories():
    """local, stream and stream_shard run the same math from the same seed:
    their reports agree on shape and trajectory (rtol 1e-4; shifts rtol
    1e-3, atol 1e-5, the reference's bounds)."""
    reports = {b: _fit(b, **({"mesh": make_host_mesh(data=4, model=1)}
                             if b == "stream_shard" else {})).fit_report_
               for b in ("local", "stream", "stream_shard")}
    ref = reports["local"]
    assert ref.iters >= 1
    for name, r in reports.items():
        assert r.iters == ref.iters, name
        assert len(r.inertia_trajectory) == len(ref.inertia_trajectory), name
        np.testing.assert_allclose(r.inertia_trajectory, ref.inertia_trajectory, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(r.centroid_shifts, ref.centroid_shifts, rtol=1e-3,
                                   atol=1e-5, err_msg=name)
