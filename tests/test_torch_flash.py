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


# Grouped KV heads: (B, S, H, Hkv, Dh), H a multiple of Hkv.
GQA_SHAPES = [(2, 96, 4, 2, 40), (1, 77, 6, 2, 33), (1, 130, 8, 1, 64)]
GQA_CASES = [(s, w, dt) for s in GQA_SHAPES for w in (0, 100) for dt in ("f32", "bf16")]
GQA_IDS = [f"{'x'.join(map(str, s))}-w{w}-{dt}" for s, w, dt in GQA_CASES]


def _gqa_qkv(shape, dtype, seed):
    """q with H heads and k, v with Hkv heads on both sides, plus the JAX k
    and v repeated to H heads (query head h reads KV head h // (H // Hkv))."""
    B, S, H, Hkv, Dh = shape
    (jq, _, _), (tq, _, _) = _qkv((B, S, H, Dh), dtype, seed)
    (jk, jv, _), (tk, tv, _) = _qkv((B, S, Hkv, Dh), dtype, seed + 1)
    reps = H // Hkv
    return (jq, jnp.repeat(jk, reps, axis=2), jnp.repeat(jv, reps, axis=2)), (tq, tk, tv)


@pytest.mark.parametrize("shape,window,dtype", GQA_CASES, ids=GQA_IDS)
def test_gqa_ops_flash_attention_matches_jax_kernel_on_repeated_kv(shape, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _gqa_qkv(shape, dtype, seed=4)
    want = jops.flash_attention(jq, jk, jv, window=window, bq=64, bk=64, interpret=True)
    before = t_flash.launches
    got = tops.flash_attention(tq, tk, tv, window=window)
    assert t_flash.launches == before
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("shape,window,dtype", GQA_CASES, ids=GQA_IDS)
def test_gqa_flash_attention_ref_matches_jax_oracle_on_repeated_kv(shape, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _gqa_qkv(shape, dtype, seed=6)
    want = jref.flash_attention_ref(jq, jk, jv, window)
    got = tref.flash_attention_ref(tq, tk, tv, window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("kv_heads", [0, 3])
def test_flash_attention_rejects_kv_heads_that_do_not_divide(kv_heads):
    q = torch.zeros((1, 8, 4, 16))
    k = v = torch.zeros((1, 8, kv_heads, 16))
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v)


# ------------------------------------------------------------------ gradients

#: (B, S, H, Hkv, Dh, window, chunk): a chunk that splits S raggedly, a window
#: shorter than a chunk, grouped KV heads, and one chunk covering S.
GRAD_CASES = [(2, 37, 4, 4, 16, 0, 8), (1, 50, 6, 3, 16, 9, 16), (2, 33, 4, 1, 8, 0, 512),
              (1, 64, 2, 2, 40, 20, 7)]


def _jax_grads(q, k, v, dout, window):
    """(dq, dk, dv) of the reference's model-side scan, the function the JAX
    package differentiates in training, k and v repeated to the query heads
    as its fwd_full does."""
    import jax

    reps = q.shape[2] // k.shape[2]
    pos = jnp.arange(q.shape[1])

    def f(q, k, v):
        return jattention._flash_attention(q, jattention._repeat_kv(k, reps),
                                           jattention._repeat_kv(v, reps), pos, pos, window,
                                           q_chunk=q.shape[1], kv_chunk=q.shape[1])

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("B,S,H,Hkv,Dh,window,chunk", GRAD_CASES)
def test_attention_backward_matches_the_references_gradient(B, S, H, Hkv, Dh, window, chunk):
    """``attention_backward`` (the Function's backward) against jax.vjp of the
    reference's scan: each gradient within 1e-5 max|g| + 1e-7 (f32 sums in
    another order)."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    want = _jax_grads(q, k, v, dout, window)
    got = t_flash.attention_backward(*(torch.from_numpy(a) for a in (q, k, v, dout)),
                                     window=window, chunk=chunk)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, name


@pytest.mark.parametrize("B,S,H,Hkv,Dh,window,chunk", GRAD_CASES)
def test_flash_function_on_the_cpu_matches_autograd_through_the_plain_version(
        B, S, H, Hkv, Dh, window, chunk, monkeypatch):
    """The Function on CPU tensors (its forward the plain version, its
    backward the recompute) against autograd through
    ``ref.flash_attention_ref``; ``ops.flash_attention`` on the CPU stays the
    plain version under autograd."""
    monkeypatch.setattr(t_flash, "BWD_CHUNK", chunk)
    g = torch.Generator().manual_seed(S)
    q = torch.randn((B, S, H, Dh), generator=g, requires_grad=True)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=g, requires_grad=True) for _ in range(2))
    dout = torch.randn((B, S, H, Dh), generator=g)
    want_out = tref.flash_attention_ref(q, k, v, window)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    out = t_flash.flash_attention(q, k, v, window=window)
    assert out.grad_fn is not None and torch.equal(out, want_out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    for name, a, b in zip("qkv", got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-7, name
    plain = tops.flash_attention(q, k, v, window=window)
    assert "Flash" not in type(plain.grad_fn).__name__ and torch.equal(plain, want_out)


def test_attention_backward_bf16_inputs_give_bf16_gradients():
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(4))
    want = _jax_grads(q, k, v, dout, 0)
    got = t_flash.attention_backward(*(torch.from_numpy(a).to(torch.bfloat16)
                                       for a in (q, k, v, dout)), chunk=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, **TOL["bf16"])
