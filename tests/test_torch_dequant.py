"""The port's Lloyd step over a quantized cache block against the JAX
package's.

The same numpy block is encoded by each package's codec (the payloads are
equal bit for bit: tests/test_torch_codec.py) and goes through the port's
plain ``fused_dequant_step_ref`` and its Y-mode plan on an ``EncodedBlock`` of
CPU tensors, and through the JAX Y-mode plan under ``ComputePolicy(pallas=True)``,
which runs the Pallas ``fused_dequant_step`` in interpret mode on the CPU.
Labels and g must be equal; Z and cost agree within rtol = atol = 1e-4, the
tolerance of tests/test_kernels_pallas.py. tests/test_torch_gpu.py holds the
CUDA kernel against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.policy import ComputePolicy as JPolicy
from repro.stream import blockstore as jbs
from repro_torch.kernels import lloyd_step as t_lloyd_step
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.stream import blockstore as tbs
from repro_torch.stream.engine import host_tensor

# (n, m, k): ragged rows (not a multiple of the 64-row tile or the TPU
# kernel's 8-row sublane) and widths that are no lane multiple.
SHAPES = [(203, 16, 5), (75, 24, 7)]
CASES = [(codec, disc, shape)
         for codec in ("int8", "bf16") for disc in ("l2", "l1") for shape in SHAPES]


def _block(n, m, seed=0):
    Y = np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)
    Y[: n // 2] += 2.0
    return Y


def _encoded(codec, Y):
    """(port EncodedBlock of CPU tensors, JAX EncodedBlock, decoded Y)."""
    p, s = tbs.get_codec(codec).encode(Y)
    pj, sj = jbs.get_codec(codec).encode(Y)
    t = tbs.EncodedBlock(host_tensor(p), torch.as_tensor(np.asarray(s, np.float32)))
    return t, jbs.EncodedBlock(jnp.asarray(pj), jnp.asarray(sj)), tbs.get_codec(codec).decode(p, s)


def _check(got, want, tol=1e-4):
    Z, g, labels, cost = (np.asarray(v) for v in got)
    Zw, gw, lw, cw = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(labels, lw)
    np.testing.assert_array_equal(g, gw)
    np.testing.assert_allclose(Z, Zw, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(cost), float(cw), rtol=tol)


@pytest.mark.parametrize("codec,disc,shape", CASES,
                         ids=[f"{c}-{d}-n{s[0]}" for c, d, s in CASES])
def test_dequant_step_matches_jax_kernel(codec, disc, shape):
    n, m, k = shape
    Y = _block(n, m)
    enc, jenc, dec = _encoded(codec, Y)
    C = dec[::max(1, n // k)][:k].copy()
    jplan = jops.lloyd_step_plan(discrepancy=disc, policy=JPolicy(pallas=True))
    want = jplan.step(jenc, jnp.asarray(C))
    Ct = torch.from_numpy(C)
    _check(ref.fused_dequant_step_ref(enc.payload, enc.scale, Ct, disc), want)
    _check(t_lloyd_step.fused_dequant_step(enc.payload, enc.scale, Ct, disc), want)
    plan = tops.lloyd_step_plan(discrepancy=disc)
    got = plan.step(enc, Ct)
    _check(got, want)
    labels, cost = plan.assign(enc, Ct)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(cost), float(want[3]), rtol=1e-4)
    # The same step on the decoded f32 block: the Y-mode plan over the
    # staged f32 cache gives the same labels and stats.
    Zd, gd, ld, cd = plan.step(torch.from_numpy(dec), Ct)
    assert torch.equal(ld, got[2]) and torch.equal(gd, got[1]) and torch.equal(Zd, got[0])


def test_decode_is_one_rounded_multiply():
    """int8 decodes as float(q) * scale in f32 (the TPU kernel's
    ``yq.astype(f32) * s``), bf16 exactly; both equal the codecs' decode."""
    Y = _block(130, 21, seed=3) * 7.0
    for codec in ("int8", "bf16"):
        enc, jenc, dec = _encoded(codec, Y)
        got = t_lloyd_step.dequant_decode(enc.payload, enc.scale)
        np.testing.assert_array_equal(got.numpy(), dec)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jenc.payload.astype(jnp.float32) * jenc.scale))


def test_dequant_wrappers_check_their_inputs():
    enc, _, _ = _encoded("int8", _block(10, 4))
    C = torch.zeros((3, 4))
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        t_lloyd_step.fused_dequant_step(enc.payload.float(), enc.scale, C, "l2")
    with pytest.raises(ValueError, match="one per column"):
        t_lloyd_step.fused_dequant_step(enc.payload, enc.scale[:, :2], C, "l2")
    with pytest.raises(ValueError, match="shape mismatch"):
        t_lloyd_step.fused_dequant_step(enc.payload, enc.scale, torch.zeros((3, 5)), "l2")
    with pytest.raises(ValueError, match="discrepancy"):
        t_lloyd_step.fused_dequant_step(enc.payload, enc.scale, C, "cos")
    bf, _, _ = _encoded("bf16", _block(10, 4))
    with pytest.raises(ValueError, match="bf16"):
        t_lloyd_step.fused_dequant_step(bf.payload, torch.ones((1, 4)), C, "l2")
