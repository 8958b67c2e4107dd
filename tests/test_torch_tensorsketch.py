"""The tensorsketch member of the port against the JAX package's: the map
from the same count-sketches S, the fit's draws and checks, the params'
serialized form, and fits through the estimator. Everything runs on the
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.embed import get_embedding as j_get_embedding
from repro.embed.tensorsketch import tensorsketch_transform as j_ts
from repro_torch.api import ComputePolicy, KernelKMeans
from repro_torch.convert import tensorsketch_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed import get_embedding, transform
from repro_torch.embed.tensorsketch import TensorSketchParams, tensorsketch_transform
from repro_torch.kernels import ops
from repro_torch.stream.blockstore import BlockStore

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def X():
    return (0.5 * np.random.default_rng(0).standard_normal((300, 9))).astype(np.float32)


@pytest.mark.parametrize("degree,coef0", [(1, 0.0), (2, 1.0), (3, 0.5)])
def test_transform_matches_jax_from_the_same_sketch(X, degree, coef0):
    """The same S in both packages: the map within rtol 1e-4, atol 1e-5 (two
    libraries' f32 FFTs over outputs of order 1 at this input scale)."""
    jkern = JKernel("poly", degree=degree, coef0=coef0)
    jparams = j_get_embedding("tensorsketch").fit(jax.random.PRNGKey(degree), jnp.asarray(X),
                                                  jkern, l=0, m=64)
    want = np.asarray(j_ts(jparams, jnp.asarray(X)))
    tparams = tensorsketch_params_from_numpy(np.asarray(jparams.S),
                                             dataclasses.asdict(jkern), device="cpu")
    got = tensorsketch_transform(tparams, torch.from_numpy(X))
    assert got.dtype == torch.float32 and got.shape == (300, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the routed dispatch takes the plain map (the member has no kernel)
    np.testing.assert_array_equal(transform(tparams, torch.from_numpy(X)).numpy(), got.numpy())
    assert ops.fused_member(tparams) is None


def test_fit_draws_count_sketches_and_checks_like_jax(X):
    emb = get_embedding("tensorsketch")
    assert emb.landmark_free
    kern = Kernel("poly", degree=3, coef0=1.0)
    p = emb.fit(5, torch.from_numpy(X), kern, l=0, m=32)
    assert isinstance(p, TensorSketchParams)
    assert p.S.shape == (3, 10, 32) and (p.m, p.d, p.discrepancy) == (32, 9, "l2")
    # one ±1 per (level, input) row
    assert torch.equal(p.S.abs().sum(dim=-1), torch.ones(3, 10))
    assert set(p.S.unique().tolist()) <= {-1.0, 0.0, 1.0}
    again = emb.fit(5, torch.from_numpy(X), kern, l=0, m=32)
    assert torch.equal(again.S, p.S)  # seeded
    # E[<ts(x), ts(z)>] = (x'z + c)^p: the mean over draws approaches the kernel
    Xt = torch.from_numpy(X[:20])
    K = kern.gram(Xt, Xt)
    est = torch.stack([
        (lambda Y: Y @ Y.T)(tensorsketch_transform(emb.fit(s, Xt, kern, l=0, m=256), Xt))
        for s in range(40)]).mean(0)
    assert float(torch.linalg.norm(est - K) / torch.linalg.norm(K)) < 0.1
    for bad, match in ((Kernel("rbf"), "polynomial"), (Kernel("poly", coef0=-1.0), "coef0")):
        with pytest.raises(ValueError, match=match):
            emb.fit(0, torch.from_numpy(X), bad, l=0, m=8)
        with pytest.raises(ValueError, match=match):
            j_get_embedding("tensorsketch").fit(
                jax.random.PRNGKey(0), jnp.asarray(X),
                JKernel(**dataclasses.asdict(bad)), l=0, m=8)
    with pytest.raises(ValueError, match="blockwise"):
        emb.fit(0, torch.from_numpy(X), kern, l=0, m=8, q=2)


def test_params_roundtrip_in_the_references_form():
    kern = dict(name="poly", gamma=1.0, degree=2, coef0=1.0, scale=1.0)
    S = np.zeros((2, 6, 8), np.float32)
    S[:, np.arange(6), np.arange(6) % 8] = 1.0
    jparams = j_get_embedding("tensorsketch").params_restore(
        {"S": S}, {"kernel": {"__kernel__": kern}})
    tparams = tensorsketch_params_from_numpy(S, kern, device="cpu")
    arrays, config = get_embedding("tensorsketch").params_state(tparams)
    want_arrays, want_config = j_get_embedding("tensorsketch").params_state(jparams)
    assert config == want_config == {"kernel": {"__kernel__": kern}}
    np.testing.assert_array_equal(arrays["S"], want_arrays["S"])
    back = get_embedding("tensorsketch").params_restore(arrays, config, device="cpu")
    assert torch.equal(back.S, tparams.S) and back.kernel == tparams.kernel


def test_bf16_route_computes_the_ffts_in_f32(X):
    p = get_embedding("tensorsketch").fit(1, torch.from_numpy(X), Kernel("poly", degree=2),
                                          l=0, m=32)
    got = transform(p, torch.from_numpy(X), ComputePolicy(precision="bf16"))
    want = tensorsketch_transform(p, torch.from_numpy(X))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2 * float(want.abs().max()))


def test_poly_fit_local_equals_stream():
    """The poly-kernel fit reaches the same labels on the local and stream
    backends from the same seed (the stream step is the un-fused route)."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((3, 6)) * 2.0
    Xb = np.concatenate([c + 0.3 * rng.standard_normal((200, 6)) for c in centers])
    Xb = Xb.astype(np.float32)
    rng.shuffle(Xb)
    kw = dict(method="tensorsketch", kernel="poly", kernel_params=dict(degree=2, coef0=1.0),
              m=32, iters=10, block_rows=128, device="cpu")
    local = KernelKMeans(3, backend="local", **kw).fit(Xb, seed=4)
    stream = KernelKMeans(3, backend="stream", **kw).fit(BlockStore.from_array(Xb, 128), seed=4)
    np.testing.assert_array_equal(local.labels_, stream.labels_)
    assert stream.inertia_ == pytest.approx(local.inertia_, rel=1e-5)
    assert local.model_.meta.method == "tensorsketch"
