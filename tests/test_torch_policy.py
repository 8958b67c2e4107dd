"""The port's kernel routing, ``ComputePolicy(kernels=...)``: the counterpart
of the JAX package's ``ComputePolicy.pallas``. Validation, the resolution on
each device, the plain bf16 route against the reference's
``ComputePolicy(pallas=False, precision="bf16")``, the un-fused plain plan,
and a member without a kernel taking its plain version. Everything runs on
the CPU; tests/test_torch_gpu.py holds the same routes on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.embed import get_embedding as j_get_embedding
from repro.embed.base import transform as j_transform
from repro.policy import ComputePolicy as JPolicy
from repro_torch import embed
from repro_torch.api import ComputePolicy, KernelKMeans
from repro_torch.convert import apnc_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.lloyd import assign_stats
from repro_torch.embed.apnc import fit_nystrom
from repro_torch.kernels import ops
from repro_torch.stream.blockstore import BlockStore, EncodedBlock, get_codec

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((3, 5)) * 4.0
    X = np.concatenate(
        [c + 0.3 * rng.standard_normal((80, 5)) for c in centers]
    ).astype(np.float32)
    rng.shuffle(X)
    return X


@pytest.mark.parametrize("kernels", [None, True, False])
def test_kernels_field_accepts_none_and_bools(kernels):
    assert ComputePolicy(kernels=kernels).kernels is kernels


@pytest.mark.parametrize("bad", [0, 1, "yes", 0.5])
def test_kernels_field_rejects_other_values(bad):
    with pytest.raises(ValueError, match="kernels"):
        ComputePolicy(kernels=bad)


def test_kernels_defaults_to_none():
    assert ComputePolicy().kernels is None


@pytest.mark.parametrize("device", ["cpu", CPU])
def test_resolve_kernels_on_a_cpu_tensor(device):
    assert ComputePolicy().resolve_kernels(device) is False
    assert ComputePolicy(kernels=False).resolve_kernels(device) is False
    with pytest.raises(ValueError, match="kernels=True"):
        ComputePolicy(kernels=True).resolve_kernels(device)


def test_resolve_kernels_on_a_card_device():
    """A CUDA device resolves without a card present: only the type is read."""
    cuda = torch.device("cuda")
    assert ComputePolicy().resolve_kernels(cuda) is True
    assert ComputePolicy(kernels=True).resolve_kernels(cuda) is True
    assert ComputePolicy(kernels=False).resolve_kernels(cuda) is False


def _jax_and_port_params(X, seed=2):
    jparams = j_get_embedding("nystrom").fit(jax.random.PRNGKey(seed), jnp.asarray(X),
                                             JKernel("rbf", gamma=0.1), l=48, m=16)
    tparams = apnc_params_from_numpy(np.asarray(jparams.landmarks), np.asarray(jparams.R),
                                     dataclasses.asdict(jparams.kernel), jparams.discrepancy,
                                     device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_plain_route_matches_jax_without_pallas(blobs, precision):
    """kernels=False is the reference's pallas=False: the same transform,
    in bf16 at the bf16 tolerance of test_bf16_transform_matches_jax."""
    jparams, tparams = _jax_and_port_params(blobs)
    want = np.asarray(j_transform(jparams, jnp.asarray(blobs),
                                  JPolicy(pallas=False, precision=precision)))
    got = embed.transform(tparams, torch.from_numpy(blobs),
                          ComputePolicy(kernels=False, precision=precision))
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    tol = 5e-2 if precision == "bf16" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)
    default = embed.transform(tparams, torch.from_numpy(blobs), ComputePolicy(precision=precision))
    assert torch.equal(got, default)  # on the CPU the default is the plain route too


def _params(X):
    return fit_nystrom(1, torch.from_numpy(X), Kernel("rbf", gamma=0.1), l=40, m=12)


def test_kernels_true_on_cpu_raises_at_every_routing_point(blobs):
    params = _params(blobs)
    X = torch.from_numpy(blobs)
    pol = ComputePolicy(kernels=True)
    Y = embed.transform(params, X)
    C = Y[:3].clone()
    payload, scale = get_codec("int8").encode(Y.numpy())
    block = EncodedBlock(torch.from_numpy(payload), torch.from_numpy(np.asarray(scale)))
    calls = {
        "transform": lambda: embed.transform(params, X, pol),
        "assign_stats": lambda: assign_stats(Y, C, 3, "l2", pol),
        "fused plan": lambda: ops.lloyd_step_plan(params, policy=pol).step(X, C),
        "y plan": lambda: ops.lloyd_step_plan(discrepancy="l2", policy=pol).step(Y, C),
        "dequant": lambda: ops.lloyd_step_plan(discrepancy="l2", policy=pol).step(block, C),
        "fit": lambda: KernelKMeans(3, kernel="rbf", method="nystrom", l=40, m=12, iters=3,
                                    policy=pol, device="cpu").fit(blobs),
    }
    for call in calls.values():
        with pytest.raises(ValueError, match="kernels=True"):
            call()


def test_plain_plan_is_unfused_and_agrees(blobs):
    """kernels=False drops the fused route, as the reference's plan does
    without Pallas; on the CPU both routes give the same labels and sums."""
    params = _params(blobs)
    X = torch.from_numpy(blobs)
    C = embed.transform(params, X)[:3].clone()
    default = ops.lloyd_step_plan(params)
    plain = ops.lloyd_step_plan(params, policy=ComputePolicy(kernels=False))
    assert default.fused and not plain.fused
    Z, g, labels, cost = plain.step(X, C)
    Zd, gd, labels_d, cost_d = default.step(X, C)
    assert torch.equal(labels, labels_d) and torch.equal(g, gd)
    torch.testing.assert_close(Z, Zd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cost, cost_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["local", "stream"])
def test_fit_with_kernels_false_equals_default_on_cpu(blobs, backend):
    """The policy reaches every fit path: on the CPU kernels=False takes the
    same plain versions the default takes there."""
    data = blobs if backend == "local" else BlockStore.from_array(blobs, 64)
    kw = dict(kernel="rbf", method="nystrom", l=40, m=12, iters=5, backend=backend,
              random_state=0, device="cpu")
    a = KernelKMeans(3, **kw).fit(data)
    b = KernelKMeans(3, policy=ComputePolicy(kernels=False), **kw).fit(data)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert a.inertia_ == pytest.approx(b.inertia_, rel=1e-6)


def test_sweep_with_kernels_false_equals_default_on_cpu(blobs):
    store = BlockStore.from_array(blobs, 64)
    kw = dict(kernel="rbf", method="nystrom", l=40, m=12, iters=5, backend="stream",
              random_state=0, device="cpu")
    a = KernelKMeans(3, **kw).sweep(store, k_grid=[2, 3], restarts=2)
    b = KernelKMeans(3, policy=ComputePolicy(kernels=False, cache_dtype="int8"), **kw).sweep(
        store, k_grid=[2, 3], restarts=2)
    c = KernelKMeans(3, policy=ComputePolicy(cache_dtype="int8"), **kw).sweep(
        store, k_grid=[2, 3], restarts=2)
    assert a.best is not None
    for i in range(2):
        for r in range(2):
            np.testing.assert_array_equal(b.labels[i][r], c.labels[i][r])
    np.testing.assert_allclose(b.inertia, c.inertia, rtol=1e-6)


def test_member_without_a_kernel_takes_its_plain_route(blobs, monkeypatch):
    """Where the kernels are asked for and a member has none
    (``kernel_transform`` returns None), ``transform`` takes the member's
    plain version, as the JAX package does without a Pallas kernel."""
    from repro_torch.embed import base

    @dataclasses.dataclass
    class DoubledParams:
        scale: torch.Tensor
        m: int = 5
        d: int = 5
        discrepancy: str = "l2"

    class Doubling(base.Embedding):
        name = "doubling-test-double"
        params_cls = DoubledParams

        def fit(self, seed, data, kernel, *, l, m, t=None, q=1):
            return DoubledParams(torch.tensor(2.0))

        def transform(self, params, X):
            return X * params.scale

    monkeypatch.setitem(base.EMBEDDINGS, Doubling.name, Doubling())
    monkeypatch.setitem(base._BY_PARAMS, DoubledParams, base.EMBEDDINGS[Doubling.name])
    # The kernel route as on a card, here on the CPU tensor.
    monkeypatch.setattr(ComputePolicy, "resolve_kernels", lambda self, device: True)
    X = torch.from_numpy(blobs)
    got = embed.transform(DoubledParams(torch.tensor(2.0)), X, ComputePolicy())
    assert torch.equal(got, X * 2.0)
