"""The port's fused Lloyd step (X-mode plan) against the JAX package's.

The same numpy inputs and the JAX package's fitted params go through
``repro_torch.kernels.ops.fused_lloyd_step`` on CPU tensors (the plain
PyTorch versions of ``fused_apnc_step`` / ``fused_rff_step``), through the JAX
fused kernels in interpret mode, and through the JAX un-fused X-mode chain.
Labels and g must be equal; Z, g and cost agree within rtol = atol = 1e-4,
the tolerance of tests/test_lloyd_plan.py. tests/test_torch_gpu.py holds the
CUDA kernels against the plain versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.core.lloyd import assign_stats as j_assign_stats
from repro.core.lloyd import block_cost as j_block_cost
from repro.embed import get_embedding as j_get_embedding
from repro.kernels import ops as jops
from repro.policy import ComputePolicy as JPolicy
from repro_torch.convert import apnc_params_from_numpy, rff_params_from_numpy
from repro_torch.kernels import lloyd_step as t_lloyd_step
from repro_torch.kernels import ops as tops

KERNELS = [
    dict(name="rbf", gamma=0.3),
    dict(name="poly", degree=2, coef0=1.0),
    dict(name="tanh", scale=0.05, coef0=0.1),
    dict(name="linear"),
]
# (n, d, l, m, k): ragged everywhere, one case wider than a 64-column chunk.
SHAPES = [(300, 6, 24, 12, 5), (515, 13, 70, 67, 7)]
# Each member meets every kernel, and each kernel both shapes across the two
# members. poly's second shape keeps m well below l: the poly gram's trailing
# eigenvalues are tiny, and R = Lambda^-1/2 V^T would scale the float32
# roundoff of both packages up past the tolerance.
APNC_CASES = [(method, kern, SHAPES[(i + j) % 2])
              for j, method in enumerate(["nystrom", "sd"])
              for i, kern in enumerate(KERNELS)]
APNC_CASES = [(method, kern, (515, 13, 70, 19, 7) if shape == SHAPES[1] and
               kern["name"] == "poly" else shape) for method, kern, shape in APNC_CASES]


def _block(n: int, d: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    """Two shifted gaussian groups, like tests/test_lloyd_plan.py's block."""
    X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    X[: n // 2] += 3.0
    return X * np.float32(scale)


def _convert(params):
    if hasattr(params, "W"):
        return rff_params_from_numpy(np.asarray(params.W), dataclasses.asdict(params.kernel),
                                     device="cpu")
    return apnc_params_from_numpy(np.asarray(params.landmarks), np.asarray(params.R),
                                  dataclasses.asdict(params.kernel), params.discrepancy,
                                  device="cpu")


def _case(method: str, kern: dict, shape):
    n, d, l, m, k = shape
    # poly's gram grows as (x.z)^2: unit-scale rows keep it, and the float32
    # roundoff the tolerance is set for, at the scale of the other kernels.
    X = _block(n, d, scale=d ** -0.5 if kern["name"] == "poly" else 1.0)
    jparams = j_get_embedding(method).fit(jax.random.PRNGKey(7), jnp.asarray(X),
                                          JKernel(**kern), l=l, m=m)
    Yj = jops.embed_block_map(jnp.asarray(X), jparams, policy=JPolicy(pallas=False))
    C = np.array(Yj[:k])
    return X, C, jparams, _convert(jparams)


def _check(got, want, tol=1e-4):
    Z, g, labels, cost = (np.asarray(v) for v in got)
    Zw, gw, lw, cw = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(labels, lw)
    np.testing.assert_array_equal(g, gw)
    np.testing.assert_allclose(Z, Zw, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(cost), float(cw), rtol=tol)


def _run_both(X, C, jparams, tparams):
    got = tops.fused_lloyd_step(torch.from_numpy(X), tparams, torch.from_numpy(C.copy()))
    Z, g, labels, cost = got
    assert labels.dtype == torch.int32 and g.shape == (C.shape[0],) and cost.ndim == 0
    got = tuple(t.numpy() for t in got)
    fused = jops.fused_lloyd_step(jnp.asarray(X), jparams, jnp.asarray(C), interpret=True)
    pol = JPolicy(pallas=False)
    Y = jops.embed_block_map(jnp.asarray(X), jparams, policy=pol)
    chain = (*j_assign_stats(Y, jnp.asarray(C), C.shape[0], jparams.discrepancy, policy=pol),
             j_block_cost(Y, jnp.asarray(C), jparams.discrepancy))
    for want in (fused, chain):
        _check(got, want)
    return got


@pytest.mark.parametrize("method,kern,shape", APNC_CASES,
                         ids=[f"{c[0]}-{c[1]['name']}-{'x'.join(map(str, c[2]))}"
                              for c in APNC_CASES])
def test_fused_apnc_step_matches_jax(method, kern, shape):
    X, C, jparams, tparams = _case(method, kern, shape)
    assert tops.fused_member(tparams) == "apnc"
    assert tparams.discrepancy == ("l2" if method == "nystrom" else "l1")
    _run_both(X, C, jparams, tparams)


@pytest.mark.parametrize("shape", [(300, 6, 0, 12, 5), (515, 13, 0, 67, 7)],
                         ids=["300x6x12x5", "515x13x67x7"])
def test_fused_rff_step_matches_jax(shape):
    X, C, jparams, tparams = _case("rff", dict(name="rbf", gamma=0.3), shape)
    assert tops.fused_member(tparams) == "rff" and C.shape[1] == 2 * shape[3]
    _run_both(X, C, jparams, tparams)


@pytest.mark.parametrize("method", ["nystrom", "sd", "rff"])
def test_plan_assign_matches_step(method):
    X, C, _, tparams = _case(method, dict(name="rbf", gamma=0.3), SHAPES[1])
    plan = tops.lloyd_step_plan(params=tparams)
    assert plan.fused and plan.discrepancy == tparams.discrepancy
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    Z, g, labels, cost = plan.step(Xt, Ct)
    la, ca = plan.assign(Xt, Ct)
    assert torch.equal(la, labels) and float(ca) == float(cost)
    # the un-fused X-mode chain and the block maps give the same step
    Zu, gu, lu, cu = tops.embed_assign_block_cost(Xt, tparams, Ct)
    assert torch.equal(lu, labels) and torch.equal(gu, g)
    torch.testing.assert_close(Zu, Z, rtol=1e-4, atol=1e-4)
    cell = [Ct]
    assert torch.equal(plan.block_map(cell)(Xt)[2], labels)
    assert torch.equal(plan.assign_map(cell)(Xt)[0], labels)
    assert torch.equal(tops.predict_block(Xt, tparams, Ct).to(torch.int32), labels)


def test_fused_member_routing():
    """q > 1 APNC and embeddings wider than the fused kernel's shared-memory
    tile go to the un-fused kernels; Y-mode plans never fuse."""
    X, C, _, tparams = _case("nystrom", dict(name="rbf", gamma=0.3), SHAPES[0])
    q2 = dataclasses.replace(tparams, landmarks=tparams.landmarks.reshape(2, 12, -1),
                             R=tparams.R[:, :6, :12].repeat(2, 1, 1))
    assert tops.fused_member(q2) is None
    assert not tops.lloyd_step_plan(params=q2).fused
    wide = dataclasses.replace(tparams, R=torch.zeros((1, t_lloyd_step.MAX_M + 1, 24)))
    assert tops.fused_member(wide) is None
    assert not tops.lloyd_step_plan(discrepancy="l2").fused
    with pytest.raises(ValueError):
        tops.fused_lloyd_step(torch.from_numpy(X), q2, torch.from_numpy(C))


def test_cpu_wrappers_do_not_count_launches():
    X, C, _, tparams = _case("nystrom", dict(name="rbf", gamma=0.3), SHAPES[0])
    before = dict(t_lloyd_step.launches)
    tops.fused_lloyd_step(torch.from_numpy(X), tparams, torch.from_numpy(C))
    assert t_lloyd_step.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "disc", "noncontig"])
def test_fused_wrappers_reject_bad_inputs(bad):
    from repro_torch.core.kernels_fn import Kernel

    X, L, R, C = torch.zeros((8, 4)), torch.zeros((5, 4)), torch.zeros((3, 5)), torch.zeros((2, 3))
    kern = Kernel("rbf")
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            t_lloyd_step.fused_apnc_step(X, L, R, C.T.contiguous(), kern, "l2")
        elif bad == "dtype":
            t_lloyd_step.fused_rff_step(X.double(), L.T.contiguous().double(),
                                        torch.zeros((2, 10)).double(), 1.0, "l2")
        elif bad == "disc":
            t_lloyd_step.fused_apnc_step(X, L, R, C, kern, "cosine")
        else:
            t_lloyd_step.fused_apnc_step(X, L, R.T, C, kern, "l2")


@pytest.mark.parametrize("tile_rows", [32, 64])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 4095, 4096, 4097, 1_262_102])
def test_launch_geometry_covers_every_tile_once(n, tile_rows):
    """Each row tile belongs to exactly one CTA, the CTAs stay within
    MAX_CTAS, none is empty, and the scratch holds one partial a CTA."""
    geo = t_lloyd_step.launch_geometry(n, tile_rows)
    assert (geo.n_tiles - 1) * tile_rows < n <= geo.n_tiles * tile_rows
    assert 1 <= geo.num_ctas <= min(geo.n_tiles, t_lloyd_step.MAX_CTAS)
    owner = np.full(geo.n_tiles, -1)
    for p in range(geo.num_ctas):
        tiles = range(p * geo.tiles_per_cta, min((p + 1) * geo.tiles_per_cta, geo.n_tiles))
        assert len(tiles) > 0 and (owner[tiles.start:tiles.stop] == -1).all()
        owner[tiles.start:tiles.stop] = p
    assert (owner >= 0).all()
    k, m = 164, 256
    assert geo.scratch_shapes(k, m) == ((geo.num_ctas, k, m), (geo.num_ctas, k),
                                        (geo.num_ctas,))


def test_each_fused_step_has_its_tile_rows():
    """fused_apnc_step takes 32-row tiles, the rff and dequant steps 64; a
    4,096-row block is then 128 and 64 CTAs."""
    assert t_lloyd_step.TILE_ROWS == {"apnc": 32, "rff": 64, "dequant": 64}
    assert t_lloyd_step.launch_geometry(4096, t_lloyd_step.TILE_ROWS["apnc"]).num_ctas == 128
    assert t_lloyd_step.launch_geometry(4096, t_lloyd_step.TILE_ROWS["rff"]).num_ctas == 64
