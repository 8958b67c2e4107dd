"""The whole slice: the port's local-backend fit and predict against the JAX
package's, on the quickstart's data (examples/quickstart.py)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKernelKMeans
from repro.api import backends as jbackends
from repro.core.metrics import nmi
from repro.data.synthetic import gaussian_blobs
from repro.stream.blockstore import BlockStore as JBlockStore
from repro.stream.reservoir import reservoir_sample as j_reservoir
from repro_torch import embed
from repro_torch.api import KernelKMeans
from repro_torch.api import backends as tbackends
from repro_torch.convert import apnc_params_from_numpy, cluster_model_from_numpy
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.reservoir import reservoir_sample


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


def test_blocks_match_jax_generator():
    from repro.data.synthetic import gaussian_blobs_blocks as j_blocks
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X, y = gaussian_blobs_blocks(3, 1000, 12, 5, block_rows=300, separation=1.5)
    Xs, ys = j_blocks(3, 1000, 12, 5, block_rows=300, separation=1.5)
    np.testing.assert_array_equal(X, Xs.materialize())
    np.testing.assert_array_equal(y, ys.materialize()[:, 0])


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
