"""`KernelKMeans.score`, `transform` and `predict` of the port against the JAX
package's, from one model fitted and saved by the JAX package and loaded into
both, for nystrom, sd, rff and tensorsketch, over an array and over a
BlockStore. Scores agree within rtol 1e-6; embeddings agree on Y Yᵀ (a
Nyström Y has free column signs), within rtol 1e-5 and atol 1e-5 of the
largest |Y Yᵀ|; labels are equal. Everything runs on the CPU."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import gaussian_blobs
from repro.stream.blockstore import BlockStore as JBlockStore
from repro_torch.api import KernelKMeans
from repro_torch.stream.blockstore import BlockStore

MEMBERS = ["nystrom", "sd", "rff", "tensorsketch"]


def _member_kwargs(method):
    if method == "tensorsketch":
        return dict(method=method, kernel="poly", kernel_params=dict(degree=2, coef0=1.0), m=32)
    if method == "rff":
        return dict(method=method, kernel=JKernel("rbf", gamma=0.05), m=16)
    return dict(method=method, l=48, m=32)


@pytest.fixture(scope="module")
def rows():
    X, _ = gaussian_blobs(jax.random.PRNGKey(2), 900, 8, 4, separation=4.0)
    X = np.array(X)
    return X[:512], X[512:]  # (fit rows, held-out rows)


@pytest.fixture(scope="module")
def loaded(rows, tmp_path_factory):
    """Each member fitted and saved by the JAX package, loaded by both."""
    X, _ = rows
    root = tmp_path_factory.mktemp("score_models")
    out = {}
    for method in MEMBERS:
        JKernelKMeans(4, iters=10, block_rows=128, backend="local",
                      **_member_kwargs(method)).fit(X, key=jax.random.PRNGKey(3)).save(
                          root / method)
        out[method] = (JKernelKMeans.load(root / method),
                       KernelKMeans.load(root / method, device="cpu"))
    return out


def _gram_close(Y, Yref):
    G, Gref = Y @ Y.T, Yref @ Yref.T
    np.testing.assert_allclose(G, Gref, rtol=1e-5, atol=1e-5 * float(np.abs(Gref).max()))


@pytest.mark.parametrize("method", MEMBERS)
def test_score_transform_predict_over_an_array(rows, loaded, method):
    _, Xq = rows
    jest, test = loaded[method]
    np.testing.assert_allclose(test.score(Xq), jest.score(Xq), rtol=1e-6)
    assert test.score(Xq) < 0
    Y, Yref = test.transform(Xq).numpy(), np.asarray(jest.transform(Xq))
    assert Y.shape == Yref.shape and Y.dtype == np.float32
    _gram_close(Y, Yref)
    np.testing.assert_array_equal(test.predict(Xq), np.asarray(jest.predict(Xq)))


@pytest.mark.parametrize("method", MEMBERS)
def test_score_transform_predict_over_a_store(rows, loaded, method):
    _, Xq = rows
    jest, test = loaded[method]
    store, jstore = BlockStore.from_array(Xq, 100), JBlockStore.from_array(Xq, 100)
    np.testing.assert_allclose(test.score(store), jest.score(jstore), rtol=1e-6)
    np.testing.assert_allclose(test.score(store), test.score(Xq), rtol=1e-6)
    Y, Yref = test.transform(store), jest.transform(jstore)
    assert (Y.n, Y.d, Y.num_blocks) == (Yref.n, Yref.d, Yref.num_blocks)
    _gram_close(Y.materialize(), Yref.materialize())
    np.testing.assert_array_equal(test.predict(store), np.asarray(jest.predict(jstore)))
