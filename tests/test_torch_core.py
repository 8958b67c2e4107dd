"""The port's core math (core/apnc, core/lloyd, embed/apnc) against the JAX
package on the same numpy inputs, at the reference's tolerances."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apnc as japnc
from repro.core.kernels_fn import Kernel as JKernel
from repro.embed import apnc as jembed
from repro_torch.core import apnc as tapnc
from repro_torch.core import lloyd as tlloyd
from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed import apnc as tembed

# repro.core re-exports a function named lloyd, which shadows the module.
jlloyd = importlib.import_module("repro.core.lloyd")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_pairwise_discrepancy_and_block_cost(disc):
    Y, C = _rand((300, 24), 0), _rand((9, 24), 1, 2.0)
    got = tapnc.pairwise_discrepancy(torch.from_numpy(Y), torch.from_numpy(C), disc)
    want = japnc.pairwise_discrepancy(jnp.asarray(Y), jnp.asarray(C), disc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tapnc.assign(torch.from_numpy(Y), torch.from_numpy(C), disc).numpy(),
        np.asarray(japnc.assign(jnp.asarray(Y), jnp.asarray(C), disc)))
    cost = tlloyd.block_cost(torch.from_numpy(Y), torch.from_numpy(C), disc)
    np.testing.assert_allclose(
        float(cost), float(jlloyd.block_cost(jnp.asarray(Y), jnp.asarray(C), disc)), rtol=1e-5)


def test_centroid_update_keeps_empty_cluster():
    Z, prev = _rand((4, 6), 2), _rand((4, 6), 3)
    g = np.array([3.0, 0.0, 1.0, 5.0], np.float32)
    got = tlloyd.centroid_update(*(torch.from_numpy(a) for a in (Z, g, prev)))
    want = jlloyd.centroid_update(*(jnp.asarray(a) for a in (Z, g, prev)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), prev[1])


def test_sufficient_stats():
    Y = _rand((200, 8), 4)
    labels = np.random.default_rng(5).integers(0, 7, 200).astype(np.int32)
    labels[labels == 3] = 2  # cluster 3 stays empty
    Z, g = tapnc.sufficient_stats(torch.from_numpy(Y), torch.from_numpy(labels), 7)
    Zw, gw = japnc.sufficient_stats(jnp.asarray(Y), jnp.asarray(labels), 7)
    np.testing.assert_allclose(Z.numpy(), np.asarray(Zw), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gw))
    assert float(g[3]) == 0.0


@pytest.mark.parametrize("kern", [dict(name="rbf", gamma=0.05), dict(name="poly", degree=2)],
                         ids=lambda k: k["name"])
def test_nystrom_on_same_landmarks(kern):
    L, X = _rand((64, 10), 6), _rand((150, 10), 7)
    m = 24
    R_t = tembed._nystrom_block(torch.from_numpy(L), Kernel(**kern), m)
    R_j = jembed._nystrom_block(jnp.asarray(L), JKernel(**kern), m)
    Y_t = tapnc.embed_block(torch.from_numpy(X), torch.from_numpy(L), R_t, Kernel(**kern))
    Y_j = np.asarray(japnc.embed_block(jnp.asarray(X), jnp.asarray(L), R_j, JKernel(**kern)))
    G_t = (Y_t @ Y_t.T).numpy()
    G_j = Y_j @ Y_j.T  # eigenvector signs are free: compare Y Y^T
    np.testing.assert_allclose(G_t, G_j, rtol=1e-4, atol=1e-4 * np.abs(G_j).max())


def test_inv_sqrt_clamped_rank_deficient_linear_gram():
    L = _rand((40, 5), 8)  # linear gram of rank 5 among 40 eigenvalues
    K = L @ L.T
    lam_t = torch.linalg.eigh(torch.from_numpy(K)).eigenvalues
    lam_j = jnp.linalg.eigh(jnp.asarray(K))[0]
    got = tembed._inv_sqrt_clamped(lam_t).numpy()
    want = np.asarray(jembed._inv_sqrt_clamped(lam_j))
    assert (got > 0).sum() == (want > 0).sum() == 5
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _jax_Y(disc: str):
    from repro.data.synthetic import gaussian_blobs

    X, _ = gaussian_blobs(jax.random.PRNGKey(0), 600, 8, 5, separation=3.0)
    kern = JKernel("rbf", gamma=0.05)
    fit = jembed.fit_nystrom if disc == "l2" else jembed.fit_sd
    params = fit(jax.random.PRNGKey(1), X, kern, l=64, m=16)
    Y = japnc.embed(X, params)
    init = jlloyd.kmeanspp_init(jax.random.PRNGKey(2), Y, 5, disc)
    return np.array(Y), np.array(init)


@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_lloyd_from_same_init(disc):
    Y, init = _jax_Y(disc)
    want = jlloyd.lloyd(jnp.asarray(Y), 5, discrepancy=disc, iters=20, init=jnp.asarray(init))
    got = tlloyd.lloyd(torch.from_numpy(Y), 5, discrepancy=disc, iters=20,
                       init=torch.from_numpy(init))
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-4)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs)[: got.iters],
                               rtol=1e-4)


def test_kmeanspp_seeds_distinct_rows():
    Y, _ = _jax_Y("l2")
    C = tlloyd.kmeanspp_init(torch.Generator().manual_seed(0), torch.from_numpy(Y), 5, "l2")
    rows = {tuple(np.round(c, 6)) for c in C.numpy()}
    assert len(rows) == 5
    assert all(np.any(np.all(np.isclose(Y, c), axis=1)) for c in C.numpy())
