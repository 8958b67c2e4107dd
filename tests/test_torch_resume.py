"""Mid-fit crash and resume in the port, on the CPU, as
tests/test_pool.py holds the JAX package's: a store whose reads fail once a
budget is spent kills a stream or minibatch fit after at least one published
iteration; a refit with the same seed and checkpoint directory resumes and
gives the uninterrupted fit's labels, iterations and inertia bit for bit. A
mismatched fingerprint is ignored, restarts keep their own directories, and
the state the port writes is the JAX package's."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.data.synthetic import gaussian_blobs_blocks
from repro.distributed import checkpoint as jck
from repro_torch.api import ComputePolicy, KernelKMeans
from repro_torch.distributed import checkpoint as ck
from repro_torch.stream import lloyd as tstream
from repro_torch.stream.blockstore import BlockStore

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def store():
    """tests/test_pool.py's blobs: 1,200 rows in 128-row blocks."""
    jstore, _ = gaussian_blobs_blocks(0, 1200, 8, 4, block_rows=128, separation=4.0)
    return BlockStore.from_array(jstore.materialize(), 128)


def _flaky(store, fail_after):
    """A store whose get() raises once ``fail_after`` reads have been served:
    a mid-fit ingest crash, at the seam a real one hits (the engine's
    producer thread)."""
    count, lock = [0], threading.Lock()

    def get(i):
        with lock:
            count[0] += 1
            if count[0] > fail_after:
                raise RuntimeError("simulated ingest crash")
        return store.get(i)

    return BlockStore(get, n=store.n, d=store.d, block_rows=store.block_rows)


def _est(backend, **kw):
    kw.setdefault("iters", 10)
    return KernelKMeans(4, method="rff", m=32, n_init=1, block_rows=128, backend=backend,
                        device="cpu", **kw)


def _assert_resume_identical(tmp_path, make_est, store, fail_after):
    ref = make_est().fit(store, seed=7)
    with pytest.raises(RuntimeError, match="simulated ingest crash"):
        make_est().fit(_flaky(store, fail_after), seed=7, checkpoint_dir=tmp_path)
    # the crash landed after at least one completed iteration was published
    skipped = ck.latest_step(tmp_path / "restart_0" / ck.LLOYD_STATE_DIR)
    assert skipped >= 1
    ck.reset_counters()
    resumed = make_est().fit(store, seed=7, checkpoint_dir=tmp_path)
    assert ck.COUNTERS["ckpt_resumes"] >= 1
    assert ck.COUNTERS["ckpt_saves"] == resumed.n_iter_ - skipped
    assert np.array_equal(ref.labels_, resumed.labels_)
    assert resumed.n_iter_ == ref.n_iter_
    assert resumed.inertia_ == ref.inertia_
    assert torch.equal(resumed.model_.centroids, ref.model_.centroids)
    return ref, resumed


def test_stream_fit_resumes_identical_after_midfit_crash(tmp_path, store):
    nb = store.num_blocks
    # the reservoir pass, iteration 1 and half of iteration 2
    _assert_resume_identical(tmp_path, lambda: _est("stream"), store, 2 * nb + nb // 2)


def test_minibatch_fit_resumes_identical_after_midfit_crash(tmp_path, store):
    nb = store.num_blocks
    # the reservoir pass, epoch 1 and half of epoch 2
    _assert_resume_identical(tmp_path, lambda: _est("minibatch", decay=0.9, epochs=3), store,
                             2 * nb + nb // 2)


@pytest.mark.parametrize("backend", ["stream", "minibatch"])
def test_nystrom_restarts_resume_from_their_own_directories(tmp_path, store, backend):
    """Two restarts, the crash inside the second restart's fit: restart 0's
    finished state and restart 1's first iteration are both adopted."""
    def make(n_init=2):
        return KernelKMeans(4, l=48, m=16, n_init=n_init, iters=6, block_rows=128,
                            backend=backend, epochs=3, device="cpu")

    ref = make().fit(store, seed=3)
    nb = store.num_blocks
    # restart 0 draws the same init alone: its passes, the final one included
    first = make(n_init=1).fit(store, seed=3).model_.meta.rows_seen // store.n
    with pytest.raises(RuntimeError, match="simulated ingest crash"):
        make().fit(_flaky(store, nb + first * nb + nb + nb // 2), seed=3, checkpoint_dir=tmp_path)
    assert ck.latest_step(tmp_path / "restart_1" / ck.LLOYD_STATE_DIR) >= 1
    ck.reset_counters()
    resumed = make().fit(store, seed=3, checkpoint_dir=tmp_path)
    assert ck.COUNTERS["ckpt_resumes"] == 2
    assert np.array_equal(ref.labels_, resumed.labels_)
    assert (resumed.n_iter_, resumed.inertia_) == (ref.n_iter_, ref.inertia_)


def test_checkpoint_ignores_mismatched_fingerprint(tmp_path, store):
    """A checkpoint of another fit (here k = 3) is not adopted: the refit runs
    from scratch and matches the uninterrupted one."""
    KernelKMeans(3, method="rff", m=32, n_init=1, iters=4, block_rows=128, backend="stream",
                 device="cpu").fit(store, seed=7, checkpoint_dir=tmp_path)
    ref = _est("stream").fit(store, seed=7)
    ck.reset_counters()
    refit = _est("stream").fit(store, seed=7, checkpoint_dir=tmp_path)
    assert ck.COUNTERS["ckpt_resumes"] == 0
    assert np.array_equal(ref.labels_, refit.labels_) and refit.n_iter_ == ref.n_iter_


def test_finished_fit_resumes_without_a_pass(tmp_path, store):
    """A refit over a finished fit's state adopts its last iteration and runs
    only the final assignment."""
    ref = _est("stream").fit(store, seed=7, checkpoint_dir=tmp_path)
    reads = [0]

    def get(i):
        reads[0] += 1
        return store.get(i)

    counted = BlockStore(get, n=store.n, d=store.d, block_rows=store.block_rows)
    again = _est("stream").fit(counted, seed=7, checkpoint_dir=tmp_path)
    assert reads[0] == 2 * store.num_blocks  # the reservoir and the final assignment
    assert np.array_equal(ref.labels_, again.labels_) and again.inertia_ == ref.inertia_


def test_y_mode_state_fingerprints_the_codec(tmp_path, store):
    """ooc_lloyd over a staged int8 Y store: its codec enters the
    fingerprint, as in the JAX package, and the state resumes bitwise."""
    X = store.materialize()
    Y = np.tanh(X @ np.random.default_rng(4).standard_normal((8, 12)).astype(np.float32))
    ystore = BlockStore.empty(n=Y.shape[0], d=12, block_rows=128, codec="int8")
    for i in range(ystore.num_blocks):
        ystore.put(i, Y[i * 128:(i + 1) * 128])
    init = torch.from_numpy(Y[[0, 300, 600, 900]].copy())
    kw = dict(discrepancy="l2", iters=8, init=init, device=CPU)
    ref = tstream.ooc_lloyd(ystore, 4, **kw)
    tstream.ooc_lloyd(ystore, 4, iters=1, **{k: v for k, v in kw.items() if k != "iters"},
                      checkpoint_dir=tmp_path)
    state = ck.load_lloyd_state(tmp_path, fingerprint=ck.lloyd_fingerprint(
        kind="ooc", n=ystore.n, d=12, k=4, m=12, init=init, cache_dtype="int8"))
    assert state is not None and state["step"] == 1
    got = tstream.ooc_lloyd(ystore, 4, **kw, checkpoint_dir=tmp_path)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert (got.iters, got.inertia, got.trajectory) == (ref.iters, ref.inertia, ref.trajectory)


def test_port_fit_state_is_read_by_the_reference(tmp_path, store):
    est = _est("minibatch", decay=0.8, epochs=2)
    est.fit(store, seed=11, checkpoint_dir=tmp_path)
    d = tmp_path / "restart_0"
    step = ck.latest_step(d / ck.LLOYD_STATE_DIR)
    assert step == 2
    fp = json.loads((d / ck.LLOYD_STATE_DIR / f"step_{step:08d}" / "manifest.json")
                    .read_text())["meta"]["lloyd"]["fingerprint"]
    assert fp["kind"] == "minibatch" and fp["decay"] == 0.8 and "cache_dtype" not in fp
    want = ck.load_lloyd_state(d, fingerprint=fp)
    got = jck.load_lloyd_state(d, fingerprint=fp)
    assert got["step"] == want["step"] == 2
    for key in ("centroids", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("Z", "g", "seen_cost"):
        np.testing.assert_array_equal(got["stats"][key], want["stats"][key])
    assert got["trajectory"] == want["trajectory"]


def test_unfused_plain_route_resumes_too(tmp_path, store):
    """The resume does not depend on the step's route: kernels=False (the
    un-fused plain versions) resumes bitwise as the default does."""
    nb = store.num_blocks
    _assert_resume_identical(
        tmp_path, lambda: _est("stream", policy=ComputePolicy(kernels=False)), store,
        2 * nb + nb // 2)
