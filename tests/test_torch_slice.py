"""The whole slice: the port's local-backend fit and predict against the JAX
package's, on the quickstart's data (examples/quickstart.py), and the
estimator's partial_fit, save and load against the JAX package's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKernelKMeans
from repro.api import backends as jbackends
from repro.core.metrics import nmi
from repro.data.synthetic import gaussian_blobs
from repro.data.synthetic import gaussian_blobs_blocks as j_blocks
from repro.stream.blockstore import BlockStore as JBlockStore
from repro.stream.reservoir import reservoir_sample as j_reservoir
from repro_torch import embed
from repro_torch.api import KernelKMeans
from repro_torch.api import backends as tbackends
from repro_torch.convert import apnc_params_from_numpy, cluster_model_from_numpy
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.reservoir import block_row_counts, reservoir_rows, reservoir_sample


@pytest.fixture(scope="module")
def blobs():
    X, y = gaussian_blobs(jax.random.PRNGKey(0), 2000, 16, 6, separation=4.0)
    return np.array(X), np.array(y)


def _jax_params_numpy(params):
    kern = dataclasses.asdict(params.kernel)
    return apnc_params_from_numpy(
        np.asarray(params.landmarks), np.asarray(params.R), kern, params.discrepancy,
        device="cpu",
    )


@pytest.mark.parametrize("method", ["nystrom", "sd"])
def test_fit_local_matches_jax_from_same_state(blobs, method):
    X, _ = blobs
    est = JKernelKMeans(6, kernel="rbf", l=128, m=64, n_init=4, backend="local",
                        method=method)
    ctx = est._prepare(X, jax.random.PRNGKey(0), "local")
    want = jbackends.fit_local(ctx)
    tctx = tbackends.FitContext(
        store=BlockStore.from_array(X, 4096),
        array=torch.from_numpy(X),
        params=_jax_params_numpy(ctx.params),
        k=6,
        inits=[torch.from_numpy(np.array(i)) for i in ctx.inits],
        iters=ctx.iters,
        policy=ComputePolicy(),
    )
    got = tbackends.fit_local(tctx)
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert got.iters == want.iters and got.rows_seen == want.rows_seen
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-4)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["nystrom", "sd"])
def test_inertia_of_a_partition_does_not_depend_on_its_numbering(blobs, method):
    """The restart selection compares inertias, and restarts that reach one
    partition number its clusters differently: a converged restart's
    centroids, permuted, give the port's inertia and the reference's bit for
    bit, and the partition's (Z, g) under renumbered labels are the same
    rows, renumbered."""
    from repro.core.lloyd import block_cost as j_block_cost
    from repro.core.lloyd import lloyd as j_lloyd
    from repro_torch.core.apnc import sufficient_stats
    from repro_torch.core.lloyd import block_cost, lloyd

    X, _ = blobs
    est = JKernelKMeans(6, kernel="rbf", l=128, m=64, n_init=4, backend="local",
                        method=method)
    ctx = est._prepare(X, jax.random.PRNGKey(0), "local")
    params = _jax_params_numpy(ctx.params)
    disc = params.discrepancy
    Y = embed.transform(params, torch.from_numpy(X))
    res = lloyd(Y, 6, discrepancy=disc, iters=ctx.iters,
                init=torch.from_numpy(np.array(ctx.inits[0])))
    Yj = jax.numpy.asarray(Y.numpy())
    jres = j_lloyd(Yj, 6, discrepancy=disc, iters=ctx.iters, init=jax.numpy.asarray(ctx.inits[0]))
    perms = [list(range(5, -1, -1)), [1, 2, 3, 4, 5, 0],
             np.random.default_rng(3).permutation(6).tolist()]
    for perm in perms:
        assert float(block_cost(Y, res.centroids[perm], disc)) == float(res.inertia)
        assert float(j_block_cost(Yj, jres.centroids[np.array(perm)], disc)) == float(
            j_block_cost(Yj, jres.centroids, disc))
        rename = torch.empty(6, dtype=torch.long)
        rename[perm] = torch.arange(6)  # cluster perm[i] becomes cluster i
        Z, g = sufficient_stats(Y, res.labels, 6)
        Zp, gp = sufficient_stats(Y, rename[res.labels.long()], 6)
        assert torch.equal(Zp, Z[perm]) and torch.equal(gp, g[perm])


def test_converted_model_predicts_like_jax(blobs):
    X, _ = blobs
    est = JKernelKMeans(6, kernel="rbf", l=128, m=64, n_init=2, backend="local").fit(X)
    jm = est.model_
    model = cluster_model_from_numpy(
        _jax_params_numpy(jm.params), np.asarray(jm.centroids), np.asarray(jm.inertia),
        dataclasses.asdict(jm.meta),
    )
    assert model.meta.k == 6 and model.meta.iters == jm.meta.iters
    Xq = X[::7]
    got = model.predict(Xq, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.predict(Xq)))


NMI_SEEDS = (0, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def fits_by_seed(blobs):
    """For each of NMI_SEEDS: (the port's fitted estimator, its NMI, the JAX
    estimator's NMI), both fitted from random_state=seed on the same data."""
    X, y = blobs
    out = {}
    for seed in NMI_SEEDS:
        jest = JKernelKMeans(6, kernel="rbf", l=128, m=64, n_init=4,
                             random_state=seed).fit(X)
        test = KernelKMeans(6, kernel="rbf", l=128, m=64, n_init=4, random_state=seed,
                            device="cpu").fit(X)
        out[seed] = (test, nmi(test.labels_, y), nmi(jest.labels_, y))
    return out


def test_estimator_nmi_close_to_jax(fits_by_seed):
    """Median NMI over the fixed seeds 0-4 of the port within 0.02 of the JAX
    package's. Each package draws its own landmarks and k-means++ seeds from
    the seed, so this compares outcomes, not draws, and a median keeps one
    unlucky draw from deciding it: at random_state=0 all four of the port's
    restarts start with two seeds in one blob and end well below the JAX
    package's NMI (ROADMAP.md, Queue 3); the cover-rate test below shows the
    port's seeding is not the weaker of the two."""
    nmi_t = np.median([fits_by_seed[s][1] for s in NMI_SEEDS])
    nmi_j = np.median([fits_by_seed[s][2] for s in NMI_SEEDS])
    assert abs(nmi_t - nmi_j) <= 0.02, (nmi_t, nmi_j)


@pytest.mark.parametrize("seed", NMI_SEEDS)
def test_estimator_serves_its_fit(blobs, fits_by_seed, seed):
    X, _ = blobs
    test, nmi_t, _ = fits_by_seed[seed]
    assert nmi_t >= 0.85, nmi_t
    assert test.backend_ == "local" and test.labels_.dtype == np.int32
    assert set(test.phases_) == {"host_view", "reservoir", "embed_fit", "seed", "lloyd"}
    served = test.predict(X[:200])
    assert (served == test.labels_[:200]).mean() >= 0.99
    assert test.score(X[:100]) < 0.0


def test_kmeanspp_cover_rate_not_worse_than_jax(blobs):
    """Share of 40 k-means++ seedings (same embedded pool) that put one seed
    in each of the six blobs: the port's draws against the JAX package's."""
    import jax.numpy as jnp

    from repro.core.lloyd import kmeanspp_init as j_kmeanspp
    from repro_torch.core.apnc import assign
    from repro_torch.core.lloyd import kmeanspp_init

    X, y = blobs
    est = KernelKMeans(6, kernel="rbf", l=128, m=64, device="cpu")
    ctx = est._prepare(X, 0, torch.device("cpu"))
    Y = embed.transform(ctx.params, ctx.array)
    pool = Y[:1024]

    def covers(C):
        return len(set(y[assign(C, Y, "l2").numpy()])) == 6

    port = np.mean([covers(kmeanspp_init(torch.Generator().manual_seed(s), pool, 6, "l2"))
                    for s in range(40)])
    ref = np.mean([covers(torch.from_numpy(np.array(j_kmeanspp(
        jax.random.PRNGKey(s), jnp.asarray(pool.numpy()), 6, "l2")))) for s in range(40)])
    assert port >= ref - 0.15, (port, ref)


@pytest.mark.parametrize("size,block_rows", [(64, 100), (500, 333), (3000, 512)])
def test_reservoir_same_rows_as_jax(blobs, size, block_rows):
    X, _ = blobs
    got = reservoir_sample(BlockStore.from_array(X, block_rows), size, seed=11)
    want = j_reservoir(JBlockStore.from_array(X, block_rows), size, seed=11)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,block_rows,size", [
    (2000, 333, 64),    # a ragged last block
    (1500, 512, 2000),  # size > n: every row, no draw
    (1500, 400, 1500),  # size == n
    (2000, 7, 5),       # a small size over many rows: slots are drawn again and again
])
def test_reservoir_rows_are_the_sampled_rows(blobs, n, block_rows, size):
    """The draws alone, replayed over the blocking's row counts, index the rows
    that `reservoir_sample` keeps, slot for slot and bit for bit."""
    X = blobs[0][:n]
    store = BlockStore.from_array(X, block_rows)
    counts = block_row_counts(n, block_rows)
    assert counts == [store.rows_of(b) for b in range(store.num_blocks)]
    rows = reservoir_rows(counts, size, seed=11)
    assert rows.dtype == np.int64 and rows.shape == (min(size, n),)
    np.testing.assert_array_equal(X[rows], reservoir_sample(store, size, seed=11))


def test_blocks_match_jax_generator():
    from repro.data.synthetic import gaussian_blobs_blocks as j_blocks
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X, y = gaussian_blobs_blocks(3, 1000, 12, 5, block_rows=300, separation=1.5)
    Xs, ys = j_blocks(3, 1000, 12, 5, block_rows=300, separation=1.5)
    np.testing.assert_array_equal(X.materialize(), Xs.materialize())
    np.testing.assert_array_equal(y.materialize(), ys.materialize())


@pytest.mark.parametrize("d,warp", [(12, False), (12, True), (2048, True), (2056, True)])
def test_blocked_stores_equal_the_references_block_by_block(d, warp):
    """Each store the port's generator returns equals the JAX package's block
    by block: its shape, dtype and every block's bits, the warp's dense form
    (d <= 2048) and its rank-256 form (d > 2048) included. Reading a block
    twice, or y before X, gives the same bits (the two-block cache)."""
    from repro.data.synthetic import gaussian_blobs_blocks as j_blocks
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.stream.blockstore import BlockStore

    n, k = (700, 5) if d < 1000 else (300, 3)
    X, y = gaussian_blobs_blocks(7, n, d, k, block_rows=128, separation=2.0, warp=warp)
    Xs, ys = j_blocks(7, n, d, k, block_rows=128, separation=2.0, warp=warp)
    assert isinstance(X, BlockStore) and isinstance(y, BlockStore)
    assert (X.n, X.d, X.num_blocks, y.d) == (Xs.n, Xs.d, Xs.num_blocks, 1)
    for i in reversed(range(X.num_blocks)):
        got_y, got_X = y.get(i), X.get(i)
        assert got_X.dtype == np.float32 and got_y.dtype == np.int32
        np.testing.assert_array_equal(got_X, Xs.get(i))
        np.testing.assert_array_equal(got_y, ys.get(i))
        np.testing.assert_array_equal(X.get(i), got_X)


def test_port_nmi_matches_jax_nmi():
    from repro_torch.core.metrics import nmi as t_nmi

    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 5, 400), rng.integers(0, 7, 400)
    assert t_nmi(a, b) == nmi(a, b)


def _convert_params(which: str, **kw):
    from repro_torch.convert import rff_params_from_numpy

    rng = np.random.default_rng(0)
    kern = dict(name="rbf", gamma=0.5)
    if which == "apnc":
        return apnc_params_from_numpy(rng.standard_normal((1, 8, 4)),
                                      rng.standard_normal((1, 6, 8)), kern, "l2", **kw)
    return rff_params_from_numpy(rng.standard_normal((4, 6)), kern, **kw)


@pytest.mark.parametrize("device", [None, "cpu"], ids=["default", "cpu"])
@pytest.mark.parametrize("which", ["apnc", "rff"])
def test_convert_defaults_to_the_card(which, device):
    """Without ``device=`` the converted params land on the card, and without
    a card that is an error; ``device="cpu"`` gives CPU tensors."""
    if device == "cpu":
        params = _convert_params(which, device="cpu")
        tensors = [params.landmarks, params.R] if which == "apnc" else [params.W]
        assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in tensors)
    elif torch.cuda.is_available():
        assert _convert_params(which).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            _convert_params(which)


# ------------------------------------------------ partial_fit, save and load


@pytest.fixture(scope="module")
def saved_jax_model(tmp_path_factory):
    """A JAX package's local fit on 512 blobs, saved by its save()."""
    X, _ = gaussian_blobs(jax.random.PRNGKey(0), 512, 8, 4, separation=4.0)
    d = tmp_path_factory.mktemp("jmodel")
    JKernelKMeans(4, l=48, m=32, iters=10, block_rows=128, backend="local").fit(
        X, key=jax.random.PRNGKey(5)).save(d)
    return d


def test_partial_fit_matches_jax_per_call(saved_jax_model):
    """Both packages warm-started from the same saved model and fed the same
    blocks: per call, the labels exactly, the centroids, Z, g and the block's
    inertia within rtol 1e-5 (atol 1e-5 of the largest |value| for the
    centroids and Z, whose entries pass through zero), rows_seen equal, R
    unchanged."""
    Xs, _ = j_blocks(1, 1024, 8, 4, block_rows=256, separation=4.0)
    jest = JKernelKMeans.load(saved_jax_model)
    test = KernelKMeans.load(saved_jax_model, device="cpu")
    R_before = test.model_.coeffs.R.clone()
    for i in range(Xs.num_blocks):
        block = Xs.get(i)
        jest.partial_fit(block)
        test.partial_fit(block)
        np.testing.assert_array_equal(test.labels_, np.asarray(jest.labels_))
        (Zj, gj, rows_j), (Zt, gt, rows_t) = jest._pf_state, test._pf_state
        assert rows_t == rows_j == test.model_.meta.rows_seen
        for got, want in ((test.model_.centroids, jest.model_.centroids), (Zt, Zj)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(want).max()))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
        assert test.inertia_ == pytest.approx(jest.inertia_, rel=1e-5)
        assert test.backend_ == jest.backend_ == "minibatch" and test.n_iter_ == 0
    assert torch.equal(test.model_.coeffs.R, R_before)


def test_partial_fit_warm_starts_from_loaded_model(blobs, tmp_path):
    """partial_fit on a fitted or loaded estimator continues from its
    ClusterModel's params, not a refit on the incoming block."""
    X, _ = blobs
    est = KernelKMeans(6, l=64, m=32, iters=10, block_rows=512, device="cpu").fit(X, seed=5)
    est.save(tmp_path / "ck")
    loaded = KernelKMeans.load(tmp_path / "ck", device="cpu")
    R_before = loaded.model_.coeffs.R.clone()
    rows_before = loaded.model_.meta.rows_seen
    loaded.partial_fit(X[:128])
    assert torch.equal(loaded.model_.coeffs.R, R_before)
    assert loaded.model_.meta.rows_seen == rows_before + 128
    est.partial_fit(X[:128])  # warm from fit(): the same update as from load()
    np.testing.assert_array_equal(est.labels_, loaded.labels_)
    assert torch.equal(est.model_.centroids, loaded.model_.centroids)
    est.sweep(X, k_grid=[6], restarts=1, seed=5)  # a sweep clears the online state
    assert est._pf_state is None


@pytest.mark.parametrize("method", ["nystrom", "rff"])
def test_partial_fit_small_first_block_raises(blobs, method):
    X, _ = blobs
    kw = dict(l=300) if method == "nystrom" else dict(method="rff", m=16)
    k = 4 if method == "nystrom" else 100
    with pytest.raises(ValueError, match="first block"):
        KernelKMeans(k, device="cpu", **kw).partial_fit(X[:64])


def test_partial_fit_cold_start_streams_blocks():
    """A cold estimator fits on its first block and then updates block by
    block; rows_seen counts every row and the model predicts the stream."""
    Xs, ys = j_blocks(1, 2048, 8, 4, block_rows=256, separation=4.0)
    est = KernelKMeans(4, l=48, m=32, decay=0.95, device="cpu")
    for i in range(Xs.num_blocks):
        est.partial_fit(Xs.get(i), seed=1)
    assert est.backend_ == "minibatch" and est.model_.meta.rows_seen == Xs.n
    assert est.labels_.shape == (256,) and est.labels_.dtype == np.int32
    labels = est.predict(BlockStore.from_array(Xs.materialize(), 256))
    assert labels.shape == (Xs.n,) and 0 <= labels.min() and labels.max() < 4


def test_load_restores_fit_hyperparameters(blobs, tmp_path):
    X, _ = blobs
    KernelKMeans(6, method="sd", l=48, m=16, n_init=2, decay=0.8, iters=10, block_rows=512,
                 device="cpu").fit(X, seed=9).save(tmp_path / "ck")
    loaded = KernelKMeans.load(tmp_path / "ck", device="cpu")
    assert (loaded.l, loaded.m, loaded.q) == (48, 16, 1)
    assert loaded.method == "sd" and loaded.n_init == 2
    assert loaded.iters == 10 and loaded.decay == 0.8 and loaded.block_rows == 512
    assert loaded.model_.params.R.device.type == "cpu"
