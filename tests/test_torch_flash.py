"""The port's attention against the JAX package's.

The same numpy q, k, v go through the reference's Pallas
``flash_attention_bhsd`` (through ``ops.flash_attention``, interpret mode on
the CPU), its oracle ``ref.flash_attention_ref`` and its model-side scan
``models.attention._flash_attention``, and through the port's
``ops.flash_attention`` on CPU tensors (the plain version, the wrapper's CPU
route), ``ref.flash_attention_ref`` and ``models.attention._flash_attention``.
Tolerances are the reference's own (tests/test_kernels_pallas.py,
tests/test_models_smoke.py): f32 rtol 2e-4 / atol 2e-5, bf16 5e-2.
tests/test_torch_gpu.py holds the CUDA kernel against the plain version on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattention

# tests/test_kernels_pallas.py's shapes, a ragged S with an odd head dim
SHAPES = [(2, 512, 3, 64), (1, 96, 2, 40), (2, 256, 4, 128), (1, 77, 2, 33)]
TOL = {"f32": dict(rtol=2e-4, atol=2e-5), "bf16": dict(rtol=5e-2, atol=5e-2)}


def _qkv(shape, dtype, seed=0):
    """numpy f32 draws, rounded to bf16 the same way on both sides."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


CASES = [(s, w, dt) for s in SHAPES for w in (0, 100) for dt in ("f32", "bf16")]
IDS = [f"{'x'.join(map(str, s))}-w{w}-{dt}" for s, w, dt in CASES]


@pytest.mark.parametrize("shape,window,dtype", CASES, ids=IDS)
def test_ops_flash_attention_matches_jax_kernel(shape, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype)
    want = jops.flash_attention(jq, jk, jv, window=window, bq=64, bk=64, interpret=True)
    before = t_flash.launches
    got = tops.flash_attention(tq, tk, tv, window=window)
    assert t_flash.launches == before  # a CPU tensor takes the plain version
    assert got.shape == shape and got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("shape,window,dtype", CASES, ids=IDS)
def test_flash_attention_ref_matches_jax_oracle(shape, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype, seed=1)
    want = jref.flash_attention_ref(jq, jk, jv, window)
    got = tref.flash_attention_ref(tq, tk, tv, window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 50])
def test_model_flash_attention_matches_reference_scan(window):
    """The port's _flash_attention against the reference's multi-chunk scan
    (several fully masked tiles, the monotone running max)."""
    shape = (2, 256, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, "f32", seed=2)
    pos = jnp.arange(shape[1])
    want = jattention._flash_attention(jq, jk, jv, pos, pos, window, q_chunk=64, kv_chunk=32)
    got = tattention._flash_attention(tq, tk, tv, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_flash_attention_reads_strided_inputs():
    """q, k, v as views with a contiguous head dim but other strides (slices
    of a fused qkv tensor) give what contiguous copies give."""
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 70, 3, 4, 24)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    got = tops.flash_attention(q, k, v, window=9)
    want = tops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=9)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "shape", "window", "stride"])
def test_flash_attention_limits_raise(bad):
    q = torch.zeros((1, 8, 2, 16))
    k, v = q.clone(), q.clone()
    kwargs = {}
    if bad == "head_dim":
        q = k = v = torch.zeros((1, 8, 2, 257))
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "shape":
        k = torch.zeros((1, 8, 1, 16))
    elif bad == "window":
        kwargs["window"] = -1
    else:
        q = torch.zeros((1, 8, 16, 2)).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        tops.flash_attention(q, k, v, **kwargs)
