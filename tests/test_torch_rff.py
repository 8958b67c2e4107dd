"""The port's rff member against the JAX package's: the map from JAX's W, the
registered member, and local vs stream fits through the public estimator."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import gaussian_blobs
from repro.embed import get_embedding as j_get_embedding
from repro.embed.rff import rff_transform as j_rff_transform
from repro.kernels import ops as jops
from repro_torch import embed
from repro_torch.api import KernelKMeans
from repro_torch.convert import rff_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.metrics import nmi
from repro_torch.embed.rff import RFFParams, rff_transform
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rff_embed as t_rff
from repro_torch.stream.blockstore import BlockStore


@pytest.mark.parametrize("shape", [(64, 8, 16), (515, 77, 130), (257, 130, 3)])
def test_rff_transform_matches_jax(shape):
    n, d, mh = shape
    X = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    kern = dict(name="rbf", gamma=0.05)
    jparams = j_get_embedding("rff").fit(jax.random.PRNGKey(2), jnp.asarray(X),
                                         JKernel(**kern), l=0, m=mh)
    params = rff_params_from_numpy(np.asarray(jparams.W), kern, device="cpu")
    assert (params.m, params.d, params.discrepancy) == (2 * mh, d, "l2")
    assert params.scale == pytest.approx(jparams.scale, rel=1e-7)
    got = rff_transform(params, torch.from_numpy(X)).numpy()
    via_wrapper = tops.rff_embed(torch.from_numpy(X), params).numpy()
    np.testing.assert_array_equal(via_wrapper, got)
    np.testing.assert_array_equal(embed.transform(params, torch.from_numpy(X)).numpy(), got)
    assert got.shape == (n, 2 * mh) and got.dtype == np.float32
    for want in (j_rff_transform(jparams, jnp.asarray(X)),
                 jops.rff_embed(jnp.asarray(X), jparams, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_rff_member_fit_and_validation():
    X = torch.randn((50, 6), generator=torch.Generator().manual_seed(0))
    emb = embed.get_embedding("rff")
    p1 = emb.fit(3, X, Kernel("rbf", gamma=0.5), l=0, m=20)
    p2 = emb.fit(3, X, Kernel("rbf", gamma=0.5), l=0, m=20)
    assert isinstance(p1, RFFParams) and torch.equal(p1.W, p2.W) and p1.W.shape == (6, 20)
    # W ~ N(0, 2 gamma): unit variance at gamma = 0.5
    assert 0.6 < float(p1.W.std()) < 1.4
    with pytest.raises(ValueError, match="shift-invariant"):
        emb.fit(3, X, Kernel("poly"), l=0, m=20)
    with pytest.raises(ValueError, match="q must be 1"):
        emb.fit(3, X, Kernel("rbf"), l=0, m=20, q=2)


def test_rff_kernel_wrapper_on_cpu_counts_no_launch():
    before = t_rff.launches
    X, W = torch.ones((5, 3)), torch.ones((3, 4))
    Y = t_rff.rff_embed_block(X, W, 0.5)
    assert Y.shape == (5, 8) and t_rff.launches == before
    with pytest.raises(ValueError):
        t_rff.rff_embed_block(X, torch.ones((4, 4)), 0.5)
    with pytest.raises(TypeError):
        t_rff.rff_embed_block(X.double(), W.double(), 0.5)


def test_rff_local_and_stream_fits_are_label_identical():
    """tests/test_api.py's rff backend equivalence, on the port."""
    X, y = gaussian_blobs(jax.random.PRNGKey(4), 600, 8, 4, separation=4.0)
    X, y = np.asarray(X), np.asarray(y)
    kw = dict(kernel=Kernel("rbf", gamma=0.05), method="rff", m=128, iters=30,
              n_init=1, block_rows=100, random_state=7, device="cpu")
    a = KernelKMeans(4, backend="local", **kw).fit(X)
    b = KernelKMeans(4, backend="stream", **kw).fit(BlockStore.from_array(X, 100))
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert b.inertia_ == pytest.approx(a.inertia_, rel=1e-4)
    assert nmi(a.labels_, y) > 0.9
    assert isinstance(b.model_.params, RFFParams) and b.model_.meta.method == "rff"
    assert b.model_.centroids.shape == (4, 256)
    np.testing.assert_array_equal(b.predict(X[:100]), b.labels_[:100])


def test_converted_rff_params_embed_like_jax():
    X = np.random.default_rng(3).standard_normal((40, 5)).astype(np.float32)
    jparams = j_get_embedding("rff").fit(jax.random.PRNGKey(9), jnp.asarray(X),
                                         JKernel("rbf", gamma=0.1), l=0, m=7)
    params = rff_params_from_numpy(np.asarray(jparams.W), dataclasses.asdict(jparams.kernel),
                                   device="cpu")
    assert params.kernel == Kernel("rbf", gamma=0.1)
    assert params.to("cpu").W.device.type == "cpu"
