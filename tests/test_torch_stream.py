"""The port's stream backend against the JAX package's: the block store, the
engine, the out-of-core and mini-batch Lloyd drivers from the same converted
state, and the estimator's local/stream label identity and auto dispatch.
Everything runs on the CPU (``device="cpu"``), through the plain versions."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import rings
from repro.embed.apnc import fit_nystrom as j_fit_nystrom
from repro.embed.apnc import fit_sd as j_fit_sd
from repro.policy import ComputePolicy as JPolicy
from repro.stream import lloyd as jstream
from repro.stream.blockstore import BlockStore as JBlockStore
from repro_torch.api import KernelKMeans, backends
from repro_torch.convert import apnc_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.stream import engine
from repro_torch.stream import lloyd as tstream
from repro_torch.stream.blockstore import BlockStore

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1030, 7)).astype(np.float32)
    X[rng.random(1030) < 0.5] += 2.5
    return X


# ------------------------------------------------------------------ store


def _pair(X, block_rows):
    return BlockStore.from_array(X, block_rows), JBlockStore.from_array(X, block_rows)


def _same(t, j):
    assert (t.n, t.d, t.block_rows, t.num_blocks, len(t)) == \
        (j.n, j.d, j.block_rows, j.num_blocks, len(j))
    for i in range(t.num_blocks):
        assert t.rows_of(i) == j.rows_of(i) and t.block_id(i) == j.block_id(i)
        assert t.row_offset(i) == j.row_offset(i)
        np.testing.assert_array_equal(t.get(i), j.get(i))
    for bt, bj in zip(t, j):
        np.testing.assert_array_equal(bt, bj)


@pytest.mark.parametrize("block_rows", [100, 333, 2048])
def test_blockstore_views_match_jax(data, block_rows):
    t, j = _pair(data, block_rows)
    _same(t, j)
    for s in range(3):
        _same(t.shard(s, 3), j.shard(s, 3))
    _same(t.map_rows(lambda b: b[:, :3] * 2.0, 3), j.map_rows(lambda b: b[:, :3] * 2.0, 3))
    np.testing.assert_array_equal(t.materialize(), j.materialize())
    with pytest.raises(IndexError):
        t.get(t.num_blocks)


def test_blockstore_generator_and_memmap_match_jax(data, tmp_path):
    def make(i):
        return np.full((min(64, 300 - 64 * i), 4), i, np.float32)

    _same(BlockStore.from_generator(make, n=300, d=4, block_rows=64),
          JBlockStore.from_generator(make, n=300, d=4, block_rows=64))
    path = tmp_path / "x.bin"
    data.tofile(path)
    _same(BlockStore.from_memmap(path, d=7, block_rows=128),
          JBlockStore.from_memmap(path, d=7, block_rows=128))
    with pytest.raises(ValueError, match="multiple"):
        BlockStore.from_memmap(path, d=9, block_rows=128)


def test_writable_store_guard_matches_jax(data):
    stores = [S.empty(n=250, d=7, block_rows=100) for S in (BlockStore, JBlockStore)]
    for st in stores:
        st.put(0, data[:100])
        st.put(2, data[200:250])
    for st in stores:
        np.testing.assert_array_equal(st.get(2), data[200:250])
        # global block 1: local 1, shard 1 of 3's local 0, local 1 of a view
        for view, i in ((st, 1), (st.shard(1, 3), 0), (st.map_rows(lambda b: b, 7), 1)):
            with pytest.raises(ValueError, match="before it was written"):
                view.get(i)
        with pytest.raises(ValueError):
            st.put(1, data[:99])


def test_codecs_are_not_ported_yet():
    """The codecs are ported (tests/test_torch_codec.py holds them against
    the JAX package); an unknown codec still raises."""
    for codec in ("bf16", "int8"):
        assert BlockStore.empty(n=10, d=2, block_rows=4, codec=codec).codec == codec
    with pytest.raises(ValueError):
        BlockStore.empty(n=10, d=2, block_rows=4, codec="fp4")


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("prefetch", [0, 2])
def test_map_reduce_prefetch_depths_agree(data, prefetch):
    store = BlockStore.from_array(data, 97)
    seen = []
    engine.reset_counters()
    total = engine.map_reduce(
        store, lambda b: b.sum(0), lambda acc, s: acc + s, torch.zeros(7, dtype=torch.float64),
        prefetch=prefetch, emit=lambda i, out: seen.append(i), device=CPU, label="sum",
    )
    np.testing.assert_allclose(total.numpy(), data.sum(0), rtol=1e-5)
    assert seen == list(range(store.num_blocks))
    assert engine.PASS_COUNTS["sum"] == 1
    assert engine.COUNTERS["blocks_read"] == store.num_blocks
    assert engine.COUNTERS["map_dispatches"] == store.num_blocks
    assert engine.COUNTERS["bytes_h2d"] == data.nbytes
    sync = engine.map_reduce(store, lambda b: b.sum(0), lambda a, s: a + s,
                             torch.zeros(7, dtype=torch.float64), prefetch=0, device=CPU)
    assert torch.equal(total, sync)


def test_prefetcher_close_returns_when_abandoned():
    def slow(i):
        time.sleep(0.01)
        return np.full((8, 3), i, np.float32)

    store = BlockStore.from_generator(slow, n=8 * 200, d=3, block_rows=8)
    pf = engine.BlockPrefetcher(store, prefetch=1, device=CPU)
    i, blk = next(pf)
    assert i == 0 and blk.shape == (8, 3)
    closer = threading.Thread(target=pf.close)
    closer.start()
    closer.join(timeout=10)
    assert not closer.is_alive()
    pf.close()  # idempotent
    with pytest.raises(StopIteration):
        next(pf)


def test_map_reduce_reraises_producer_errors():
    def bad(i):
        if i == 2:
            raise RuntimeError("disk gone")
        return np.zeros((4, 2), np.float32)

    store = BlockStore.from_generator(bad, n=20, d=2, block_rows=4)
    with pytest.raises(RuntimeError, match="disk gone"):
        engine.map_reduce(store, lambda b: b, lambda a, b: a, None, device=CPU)


# ------------------------------------------------------------ drivers


@pytest.fixture(scope="module", params=["nystrom", "sd"])
def member_state(request, data):
    """JAX-fitted params and a JAX k-means++ init, plus their port copies."""
    fit = j_fit_nystrom if request.param == "nystrom" else j_fit_sd
    kern = JKernel("rbf", gamma=0.2)
    jparams = fit(jax.random.PRNGKey(3), jnp.asarray(data), kern, l=40, m=16)
    from repro.core.lloyd import kmeanspp_init
    from repro.kernels import ops as jops

    pool = jops.embed_block_map(jnp.asarray(data[:512]), jparams,
                                policy=JPolicy(pallas=False))
    init = np.array(kmeanspp_init(jax.random.PRNGKey(5), pool, 4, jparams.discrepancy))
    tparams = apnc_params_from_numpy(np.asarray(jparams.landmarks), np.asarray(jparams.R),
                                     dataclasses.asdict(kern), jparams.discrepancy,
                                     device="cpu")
    return jparams, tparams, init


def _compare(got, want):
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-4)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-4, atol=1e-4)
    assert got.iters == want.iters and got.rows_seen == want.rows_seen
    assert len(got.trajectory) == len(want.trajectory)
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=1e-4)
    assert len(got.shifts) == len(want.shifts)


@pytest.fixture(scope="module")
def jax_ooc(data, member_state):
    jparams, _, init = member_state
    return jstream.ooc_lloyd(JBlockStore.from_array(data, 128), 4, coeffs=jparams,
                             init=jnp.asarray(init), iters=15, policy=JPolicy(pallas=False))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_ooc_lloyd_matches_jax(data, member_state, jax_ooc, prefetch):
    _, tparams, init = member_state
    got = tstream.ooc_lloyd(BlockStore.from_array(data, 128), 4, coeffs=tparams,
                            init=torch.from_numpy(init), iters=15, prefetch=prefetch,
                            device=CPU)
    _compare(got, jax_ooc)
    assert got.trajectory[-1] == got.inertia


def test_minibatch_lloyd_matches_jax(data, member_state):
    jparams, tparams, init = member_state
    want = jstream.minibatch_lloyd(JBlockStore.from_array(data, 128), 4, coeffs=jparams,
                                   init=jnp.asarray(init), decay=0.8, epochs=2,
                                   policy=JPolicy(pallas=False))
    got = tstream.minibatch_lloyd(BlockStore.from_array(data, 128), 4, coeffs=tparams,
                                  init=torch.from_numpy(init), decay=0.8, epochs=2,
                                  device=CPU)
    _compare(got, want)


def test_y_mode_stream_matches_x_mode(data, member_state):
    """The staged-Y cache (ensure_embedding_cache) clusters to the labels of
    the X-mode stream from the same init."""
    _, tparams, init = member_state
    ctx = backends.FitContext(
        store=BlockStore.from_array(data, 128), array=None, params=tparams, k=4,
        inits=[torch.from_numpy(init)], iters=15, policy=KernelKMeans(4).policy,
    )
    x_mode = backends.fit_stream(ctx)
    assert backends.ensure_embedding_cache(ctx).y_store.n == data.shape[0]
    y_store = ctx.y_store
    assert backends.ensure_embedding_cache(ctx).y_store is y_store  # idempotent
    y_mode = backends.fit_stream(ctx)
    np.testing.assert_array_equal(y_mode.labels, x_mode.labels)
    np.testing.assert_allclose(y_mode.inertia, x_mode.inertia, rtol=1e-5)
    local = backends.fit_local(ctx)
    np.testing.assert_array_equal(local.labels, x_mode.labels)


def test_drivers_reject_what_is_not_ported(data, member_state):
    """The sharded stream is ported: ``devices=`` and ``mesh=`` route
    `ooc_lloyd` through it and reach the single-device labels; what the
    drivers still reject is a bad call."""
    from repro_torch.launch.mesh import make_mesh

    _, tparams, init = member_state
    store = BlockStore.from_array(data, 128)
    single = tstream.ooc_lloyd(store, 4, coeffs=tparams, init=torch.from_numpy(init),
                               device=CPU)
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    for kw in (dict(devices=[CPU] * 4), dict(mesh=mesh)):
        got = tstream.ooc_lloyd(store, 4, coeffs=tparams, init=torch.from_numpy(init), **kw)
        np.testing.assert_array_equal(got.labels, single.labels)
    with pytest.raises(ValueError, match="at most one of devices= and mesh="):
        tstream.ooc_lloyd(store, 4, coeffs=tparams, init=torch.from_numpy(init),
                          devices=[CPU], mesh=mesh)
    with pytest.raises(ValueError, match="needs devices="):
        tstream.ooc_lloyd(store, 4, coeffs=tparams, init=torch.from_numpy(init),
                          device=CPU, scheduler="pool")
    with pytest.raises(ValueError, match="exactly one"):
        tstream.ooc_lloyd(store, 4, init=torch.from_numpy(init), device=CPU)
    got = tstream.ooc_lloyd(store, 4, coeffs=tparams, generator=torch.Generator().manual_seed(0),
                            device=CPU)
    assert got.labels.shape == (data.shape[0],) and set(got.labels) <= set(range(4))


# -------------------------------------------------------------- estimator


@pytest.fixture(scope="module")
def rings_600():
    X, _ = rings(jax.random.PRNGKey(0), 600, k=2, noise=0.05, gap=2.0)
    return np.asarray(X)


@pytest.mark.parametrize("iters", [30, 1], ids=["converged", "iteration-cap"])
def test_local_and_stream_fits_are_label_identical(rings_600, iters):
    """tests/test_api.py's backend equivalence, on the port: same data, same
    seed, local and stream land on identical labels (at the cap too), and the
    fit labels replay through predict."""
    kw = dict(kernel=Kernel("rbf", gamma=1.0), l=64, m=64, iters=iters, n_init=1,
              block_rows=100, random_state=7, device="cpu")
    a = KernelKMeans(2, backend="local", **kw).fit(rings_600)
    b = KernelKMeans(2, backend="stream", **kw).fit(BlockStore.from_array(rings_600, 100))
    assert a.backend_ == "local" and b.backend_ == "stream"
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert b.inertia_ == pytest.approx(a.inertia_, rel=1e-4)
    np.testing.assert_allclose(a.model_.centroids.numpy(), b.model_.centroids.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(a.labels_, a.predict(rings_600))
    np.testing.assert_array_equal(b.predict(BlockStore.from_array(rings_600, 128)), b.labels_)
    assert b.score(BlockStore.from_array(rings_600, 64)) == pytest.approx(-b.inertia_, rel=1e-4)
    Ys = b.transform(BlockStore.from_array(rings_600, 128)).materialize()
    np.testing.assert_allclose(Ys, b.transform(rings_600).numpy(), atol=1e-5)
    assert set(b.phases_) == {"host_view", "reservoir", "embed_fit", "seed", "lloyd"}


def test_minibatch_backend_through_the_estimator(rings_600):
    est = KernelKMeans(2, kernel=Kernel("rbf", gamma=1.0), l=64, m=64, backend="minibatch",
                       decay=0.7, epochs=3, block_rows=100, device="cpu").fit(rings_600)
    assert est.backend_ == "minibatch" and est.n_iter_ == 3
    assert est.model_.meta.decay == 0.7 and est.model_.meta.epochs == 3
    assert est.model_.meta.rows_seen == 4 * 600


def test_auto_picks_the_backends_jax_picks(rings_600):
    big = np.zeros((2_000_000, 1), np.float32)
    cases = [rings_600, big[:-1], big]
    for X in cases:
        want = JKernelKMeans(2)._choose_backend(X)
        assert KernelKMeans(2)._choose_backend(X) == want
    assert KernelKMeans(2)._choose_backend(big) == "stream"
    store = BlockStore.from_array(rings_600, 100)
    assert KernelKMeans(2)._choose_backend(store) == \
        JKernelKMeans(2)._choose_backend(JBlockStore.from_array(rings_600, 100)) == "stream"
    assert KernelKMeans(2, backend="local")._choose_backend(store) == "local"


def test_stream_fit_keeps_the_array_off_the_device(rings_600):
    """Only the local backend gets the whole array as a device tensor, and
    no host view beside it; the stream backends see the blocked host view."""
    est = KernelKMeans(2, kernel=Kernel("rbf", gamma=1.0), l=32, m=16, device="cpu")
    for name, resident in (("local", True), ("stream", False), ("minibatch", False)):
        ctx = est._prepare(rings_600, 0, CPU, name)
        assert (ctx.array is not None) == resident and (ctx.store is None) == resident
        assert resident or ctx.store.n == 600
    ctx = est._prepare(BlockStore.from_array(rings_600, 100), 0, CPU, "stream")
    assert ctx.array is None
    with pytest.raises(ValueError, match="sharded"):
        est.fit(BlockStore.from_array(rings_600, 100).shard(0, 2))


@pytest.mark.parametrize("method", ["nystrom", "sd"])
def test_resident_phase1_is_the_host_views(rings_600, method):
    """A local fit of an array gathers its reservoir from the array and a
    stream fit of the same rows as a BlockStore from the host blocks: the
    same seed gives the same landmarks, gamma (self-tuned on the sample), R
    and seeding pool, bit for bit."""
    est = KernelKMeans(2, kernel="rbf", method=method, l=32, m=16, block_rows=70,
                       landmark_sample=150, seed_sample=100, device="cpu")
    store, array, params, pool, s_seed = est._phase1(rings_600, 3, CPU, "local")
    assert store is None and array is not None
    _, _, want_params, want_pool, want_seed = est._phase1(
        BlockStore.from_array(rings_600, 70), 3, CPU, "stream")
    assert s_seed == want_seed and params.kernel.gamma == want_params.kernel.gamma
    assert torch.equal(params.landmarks, want_params.landmarks)
    assert torch.equal(params.R, want_params.R) and torch.equal(pool, want_pool)
