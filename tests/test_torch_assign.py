"""The port's assign step (``apnc_assign_step``: labels, (Z, g) and the block's
cost in one launch) against the JAX package, its launch geometry, and the
Y-mode plan's routing, on the CPU.

The same numpy inputs go through the JAX Pallas kernel in interpret mode
(``repro.kernels.ops.apnc_assign``) with the reference's ``block_cost``, and
through the port's wrapper on CPU tensors, which computes with the plain
PyTorch version. tests/test_torch_gpu.py holds the CUDA kernel against the
plain version and the fused steps on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lloyd import block_cost as j_block_cost
from repro.kernels import ops as jops
from repro_torch.core.lloyd import block_cost
from repro_torch.kernels import apnc_assign as t_assign
from repro_torch.kernels import lloyd_step as t_lloyd_step
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.policy import ComputePolicy

# (n, k, m): a ragged last 32-row tile, k not a multiple of 32, and m above
# 800 (past the fused dequant step's tile) and above the tiled kernel's 832.
SHAPES = [(100, 7, 70), (1003, 37, 24), (65, 164, 256), (33, 5, 840)]


def _case(n, k, m, seed=0):
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((n, m)) * m ** -0.5).astype(np.float32)
    C = Y[rng.choice(n, size=k, replace=k > n)] + (
        rng.standard_normal((k, m)) * 0.1 * m ** -0.5).astype(np.float32)
    return Y, np.ascontiguousarray(C, dtype=np.float32)


@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nkm", SHAPES, ids=lambda s: "n{}-k{}-m{}".format(*s))
def test_assign_step_matches_jax(disc, nkm):
    """Labels and g equal the Pallas kernel's, Z within the reference's
    tolerance (tests/test_kernels_pallas.py), the cost within rtol 1e-5 of the
    reference's block_cost."""
    Y, C = _case(*nkm)
    Z, g, labels, cost = t_assign.apnc_assign_step(torch.from_numpy(Y), torch.from_numpy(C), disc)
    Zw, gw, lw = jops.apnc_assign(jnp.asarray(Y), jnp.asarray(C), disc, interpret=True)
    assert labels.dtype == torch.int32 and cost.shape == () and cost.dtype == torch.float32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(lw))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gw))
    np.testing.assert_allclose(Z.numpy(), np.asarray(Zw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(cost), float(j_block_cost(jnp.asarray(Y), jnp.asarray(C),
                                                                disc)), rtol=1e-5)


@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_assign_is_the_step_without_its_cost(disc):
    Y, C = (torch.from_numpy(a) for a in _case(300, 11, 40, seed=1))
    step = t_assign.apnc_assign_step(Y, C, disc)
    for got, want in zip(t_assign.apnc_assign(Y, C, disc), step[:3]):
        assert torch.equal(got, want)
    assert torch.equal(step[3], block_cost(Y, C, disc))
    for got, want in zip(step, ref.apnc_assign_step_ref(Y, C, disc)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4095, 4096, 4097, 40_000, 1_262_102])
def test_assign_launch_geometry_is_the_fused_steps(n):
    """Up to MAX_M the assign kernel takes the fused steps' 32-row tiles and
    CTAs, so its per-CTA partials and their reduction are theirs; above it,
    the streamed kernel's 64-row tiles under the same rule."""
    assert t_assign.TILE_ROWS == 32 and set(t_lloyd_step.TILE_ROWS.values()) == {32}
    for m in (24, 256, t_assign.MAX_M):
        assert t_assign.launch_geometry(n, m) == t_lloyd_step.launch_geometry(n, 32)
    assert t_assign.launch_geometry(n, t_assign.MAX_M + 1) == t_lloyd_step.launch_geometry(n, 64)


def test_assign_max_m_fits_the_tile():
    """MAX_M is the widest multiple of 32 whose Y^T tile (pitch 36), the raw
    rows (odd 16-byte pitch) or the epilogue's C buffers, and the epilogue's
    scratch fit in a CTA's 232,448 bytes of shared memory."""
    def smem(m):
        raw = 4 * 32 * ((m // 4) | 1)
        return 4 * (m * 36 + max(raw, 2 * 256 * 36) + 9 * 32 + 256 + 1)

    assert t_assign.MAX_M % 32 == 0
    assert smem(t_assign.MAX_M) <= 232_448 < smem(t_assign.MAX_M + 32)
    assert smem(256) == 112_772


@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_y_mode_plan_cost_is_block_cost_on_cpu(disc):
    """On the CPU the Y-mode step is the plain route: assign_stats and
    block_cost, no launch, whatever the policy says short of kernels=True."""
    Y, C = (torch.from_numpy(a) for a in _case(515, 13, 24, seed=2))
    before = t_assign.launches
    for pol in (None, ComputePolicy(kernels=False)):
        Z, g, labels, cost = tops.lloyd_step_plan(discrepancy=disc, policy=pol).step(Y, C)
        assert torch.equal(cost, block_cost(Y, C, disc))
        Zr, gr, lr = ref.apnc_assign_ref(Y, C, disc)
        assert torch.equal(labels, lr) and torch.equal(g, gr) and torch.equal(Z, Zr)
    assert t_assign.launches == before


def test_y_mode_plan_with_kernels_true_raises_on_cpu():
    Y, C = (torch.from_numpy(a) for a in _case(64, 3, 16, seed=3))
    plan = tops.lloyd_step_plan(discrepancy="l2", policy=ComputePolicy(kernels=True))
    with pytest.raises(ValueError, match="kernels=True"):
        plan.step(Y, C)
    with pytest.raises(ValueError, match="kernels=True"):
        plan.assign(Y, C)


@pytest.mark.parametrize("bad", ["shape", "dtype", "disc", "noncontig", "empty"])
def test_assign_step_rejects_bad_inputs(bad):
    Y, C = torch.zeros((8, 4)), torch.zeros((3, 4))
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            t_assign.apnc_assign_step(Y, C.T.contiguous(), "l2")
        elif bad == "dtype":
            t_assign.apnc_assign_step(Y.double(), C.double(), "l2")
        elif bad == "disc":
            t_assign.apnc_assign_step(Y, C, "cosine")
        elif bad == "noncontig":
            t_assign.apnc_assign_step(Y.T.contiguous().T, C, "l2")
        else:
            t_assign.apnc_assign_step(Y, C[:0], "l2")
