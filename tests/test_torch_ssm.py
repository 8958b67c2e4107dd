"""The port's SSM mixers (Mamba, RWKV6) and their layer groups against the
JAX package's.

Weights cross over by name from the reference's init (torch and jax.random
draws differ by construction); inputs are numpy draws handed to both.
Everything runs on the CPU at reduced widths. Tolerances: activations rtol
1e-4 / atol 1e-5 (the reference's own for the chunked WKV against the scan,
tests/test_models_smoke.py); f32 states the same; bf16 states (the conv
window, x_tmix, x_cmix) bit for bit or one bf16 ulp apart on at most 1 % of
the elements, where an f32 value that differs in its last place sits at a
bf16 rounding boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro.models.common import TEST_POLICY as JPOLICY
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import TEST_POLICY

TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-3b"


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jreduced(jget_arch(arch)), **overrides),
            dataclasses.replace(reduced(get_arch(arch)), **overrides))


def _load(module, tree):
    """The reference's leaves into ``module``'s parameters of the same names."""
    params = dict(module.named_parameters())
    assert set(params) == set(tree)
    with torch.no_grad():
        for name, value in tree.items():
            assert tuple(params[name].shape) == tuple(value.shape), name
            assert params[name].dtype == torch.float32
            params[name].copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return module


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(x).view(np.uint16).astype(np.int32)


def _assert_bf16_equal(got, want, what):
    assert got.dtype == torch.bfloat16 and np.asarray(want).dtype == jnp.bfloat16, what
    diff = np.abs(_bits(got) - _bits(want))
    assert diff.max() <= 1, f"{what}: differs by {diff.max()} bf16 ulps"
    assert (diff > 0).mean() <= 0.01, f"{what}: {(diff > 0).sum()} of {diff.size} differ"


def _assert_state_close(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for name, value in want.items():
        if np.asarray(value).dtype == jnp.bfloat16:
            _assert_bf16_equal(got[name], value, f"{what} {name}")
        else:
            assert got[name].dtype == torch.float32, (what, name)
            _close(got[name], value, err_msg=f"{what} {name}", **TOL)


# ---------------------------------------------------------------- group norm


@pytest.mark.parametrize("groups,dtype", [(4, np.float32), (5, np.float32), (4, "bfloat16")])
def test_group_norm_matches_the_reference(groups, dtype):
    x = _x((2, 7, 80), 0, 3.0) + 1.5
    scale, bias = _x((80,), 1), _x((80,), 2)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = jcommon.group_norm(jx, jnp.asarray(scale), jnp.asarray(bias), groups, 64e-5)
    got = tcommon.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), groups, 64e-5)
    assert str(got.dtype).endswith(str(want.dtype))
    if dtype == "bfloat16":
        _assert_bf16_equal(got, want, "group_norm")
    else:
        _close(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- Mamba


def _mamba_pair(seed=0):
    jcfg, tcfg = _cfgs(JAMBA)
    jp = jmamba.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    # a non-zero conv bias and D, so that both are exercised
    jp = dict(jp, conv_b=jnp.asarray(_x(jp["conv_b"].shape, seed + 1, 0.1)),
              D=jnp.asarray(1.0 + _x(jp["D"].shape, seed + 2, 0.1)))
    return jcfg, tcfg, jp, _load(tmamba.Mamba(tcfg, TEST_POLICY), jp)


def test_mamba_init_layouts_match_the_reference():
    jcfg, tcfg = _cfgs(JAMBA)
    jp = jmamba.init(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tp = tmamba.init(torch.Generator().manual_seed(0), tcfg, TEST_POLICY, "cpu")
    got = {n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
    assert got == {n: (tuple(v.shape), getattr(torch, str(v.dtype))) for n, v in jp.items()}
    for name in ("conv_b", "dt_bias", "A_log", "D"):  # the deterministic leaves
        _close(getattr(tp, name), jp[name], rtol=1e-6, atol=0)


def test_mamba_pieces_match_the_reference():
    jcfg, tcfg, jp, tp = _mamba_pair()
    x = _x((2, 11, jcfg.d_model), 3)
    xb_j, z_j = jmamba._split_proj(jp, jcfg, JPOLICY, jnp.asarray(x))
    xb_t, z_t = tmamba._split_proj(tp, TEST_POLICY, torch.from_numpy(x))
    _close(xb_t, xb_j)
    _close(z_t, z_j)
    conv_j = jmamba._conv_full(jp, jcfg, JPOLICY, xb_j)
    conv_t = tmamba._conv_full(tp, tcfg, TEST_POLICY, xb_t)
    _close(conv_t, conv_j)
    xc = _x(conv_j.shape, 4)
    for got, want in zip(tmamba._ssm_inputs(tp, tcfg, TEST_POLICY, torch.from_numpy(xc)),
                         jmamba._ssm_inputs(jp, jcfg, JPOLICY, jnp.asarray(xc))):
        assert got.dtype == torch.float32
        _close(got, want)
    assert tcfg.resolved_dt_rank == -(-tcfg.d_model // 16)


@pytest.mark.parametrize("S", [1, 2, 13])
def test_mamba_fwd_full_and_prefill_state_match_the_reference(S):
    """fwd_full; the final (h, conv) of the one loop against the reference's
    second scan (``transformer._mamba_prefill``); a sequence shorter than
    the conv window pads its state with zeros, where the reference's state
    comes out short."""
    jcfg, tcfg, jp, tp = _mamba_pair(1)
    x = _x((2, S, jcfg.d_model), 5)
    want = jmamba.fwd_full(jp, jcfg, JPOLICY, jnp.asarray(x))
    _close(tmamba.fwd_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x)), want)
    y, state = tmamba.fwd_prefill(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    jy, jstate = jtransformer._mamba_prefill(jp, jcfg, JPOLICY, jnp.asarray(x))
    _close(y, jy)
    assert state["conv"].shape == (2, tcfg.ssm_conv - 1, tcfg.ssm_d_inner)
    if S >= tcfg.ssm_conv - 1:
        _assert_state_close(state, jstate, "prefill state")
    else:
        _close(state["h"], jstate["h"])
        pad = tcfg.ssm_conv - 1 - S
        assert not state["conv"][:, :pad].any()
        _assert_bf16_equal(state["conv"][:, pad:], jstate["conv"], "short conv state")


def test_mamba_init_state_and_decode_match_the_reference():
    jcfg, tcfg, jp, tp = _mamba_pair(2)
    t0 = tmamba.init_state(tcfg, 3, torch.bfloat16)
    j0 = jmamba.init_state(jcfg, 3, jnp.bfloat16)
    for name in ("h", "conv"):
        assert tuple(t0[name].shape) == j0[name].shape and not t0[name].any()
        assert str(t0[name].dtype).endswith(str(j0[name].dtype))
    h = _x(j0["h"].shape, 6, 0.5)
    conv = _x(j0["conv"].shape, 7)
    jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv).astype(jnp.bfloat16)}
    tstate = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv).to(torch.bfloat16)}
    x = _x((3, 1, jcfg.d_model), 8)
    for step in range(3):
        jy, jstate = jmamba.fwd_decode(jp, jcfg, JPOLICY, jnp.asarray(x), jstate)
        ty, tstate = tmamba.fwd_decode(tp, tcfg, TEST_POLICY, torch.from_numpy(x), tstate)
        _close(ty, jy, err_msg=f"step {step}", **TOL)
        _assert_state_close(tstate, jstate, f"step {step}")
        x = np.array(jy)


# --------------------------------------------------------------------- RWKV6


def _tmix_pair(seed=0, **overrides):
    jcfg, tcfg = _cfgs(RWKV, **overrides)
    jp = jrwkv6.init_tmix(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, jp, _load(trwkv6.TimeMix(tcfg, TEST_POLICY), jp)


def _cmix_pair(seed=0):
    jcfg, tcfg = _cfgs(RWKV)
    jp = jrwkv6.init_cmix(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, jp, _load(trwkv6.ChannelMix(tcfg, TEST_POLICY), jp)


def test_rwkv6_init_layouts_and_padded_heads():
    """The reduced rwkv6 has 5 physical wkv heads for 4 real ones (d_model
    64 / head size 16): the padded head's columns of wr, wk, wv, wg are zero
    from init, as the reference's."""
    jcfg, tcfg = _cfgs(RWKV)
    assert (tcfg.phys_heads, tcfg.rwkv_num_heads) == (5, 4)
    jt = jrwkv6.init_tmix(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tt = trwkv6.init_tmix(torch.Generator().manual_seed(0), tcfg, TEST_POLICY, "cpu")
    jc = jrwkv6.init_cmix(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tc = trwkv6.init_cmix(torch.Generator().manual_seed(0), tcfg, TEST_POLICY, "cpu")
    for tp, jp in ((tt, jt), (tc, jc)):
        got = {n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
        assert got == {n: (tuple(v.shape), getattr(torch, str(v.dtype))) for n, v in jp.items()}
    hs = tcfg.rwkv_head_size
    for name in ("wr", "wk", "wv", "wg"):
        w = getattr(tt, name)
        assert not w[:, 4 * hs:].any() and w[:, :4 * hs].all()
        assert not np.asarray(jt[name])[:, 4 * hs:].any()
    for name in ("w0", "ln_scale", "ln_bias"):
        _close(getattr(tt, name), jt[name], rtol=0, atol=0)


def test_rwkv6_pieces_match_the_reference():
    """_ddlerp, _wkv_inputs, _wkv_step and _finish_tmix."""
    jcfg, tcfg, jp, tp = _tmix_pair(1)
    x, x_prev = _x((2, 9, jcfg.d_model), 10), _x((2, 9, jcfg.d_model), 11)
    for got, want in zip(trwkv6._ddlerp(tp, TEST_POLICY, torch.from_numpy(x),
                                        torch.from_numpy(x_prev)),
                         jrwkv6._ddlerp(jp, JPOLICY, jnp.asarray(x), jnp.asarray(x_prev))):
        _close(got, want)
    got = trwkv6._wkv_inputs(tp, tcfg, TEST_POLICY, torch.from_numpy(x), torch.from_numpy(x_prev))
    want = jrwkv6._wkv_inputs(jp, jcfg, JPOLICY, jnp.asarray(x), jnp.asarray(x_prev))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    B, Hp, hs = 2, tcfg.phys_heads, tcfg.rwkv_head_size
    S0 = _x((B, Hp, hs, hs), 12, 0.3)
    r, k, v = (_x((B, Hp, hs), 13 + i) for i in range(3))
    w = np.random.default_rng(16).uniform(0.2, 1.0, (B, Hp, hs)).astype(np.float32)
    u = np.asarray(jp["u"])
    for a, b in zip(trwkv6._wkv_step(*(torch.from_numpy(t) for t in (S0, r, k, v, w, u))),
                    jrwkv6._wkv_step(*(jnp.asarray(t) for t in (S0, r, k, v, w, u)))):
        _close(a, b)
    y, g = _x((2, 9, Hp * hs), 17), _x((2, 9, Hp * hs), 18)
    _close(trwkv6._finish_tmix(tp, tcfg, TEST_POLICY, torch.from_numpy(y), torch.from_numpy(g)),
           jrwkv6._finish_tmix(jp, jcfg, JPOLICY, jnp.asarray(y), jnp.asarray(g)))


@pytest.mark.parametrize("S", [1, 17])
def test_rwkv6_tmix_full_and_prefill_state_match_the_reference(S):
    jcfg, tcfg, jp, tp = _tmix_pair(2)
    x = _x((2, S, jcfg.d_model), 20)
    want = jrwkv6.fwd_tmix_full(jp, jcfg, JPOLICY, jnp.asarray(x))
    _close(trwkv6.fwd_tmix_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x)), want)
    y, state = trwkv6.fwd_tmix_prefill(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    jy, jstate = jtransformer._rwkv_prefill(jp, jcfg, JPOLICY, jnp.asarray(x))
    _close(y, jy)
    _assert_state_close(state, jstate, "prefill state")


def test_rwkv6_init_state_and_decode_match_the_reference():
    jcfg, tcfg, jt, tt = _tmix_pair(3)
    _, _, jc, tc = _cmix_pair(3)
    t0 = trwkv6.init_state(tcfg, 2, torch.bfloat16)
    j0 = jrwkv6.init_state(jcfg, 2, jnp.bfloat16)
    for name in ("S", "x_tmix", "x_cmix"):
        assert tuple(t0[name].shape) == j0[name].shape and not t0[name].any()
        assert str(t0[name].dtype).endswith(str(j0[name].dtype))
    S0 = _x(j0["S"].shape, 21, 0.3)
    xt, xc = _x(j0["x_tmix"].shape, 22), _x(j0["x_cmix"].shape, 23)
    jstate = {"S": jnp.asarray(S0), "x_tmix": jnp.asarray(xt).astype(jnp.bfloat16),
              "x_cmix": jnp.asarray(xc).astype(jnp.bfloat16)}
    tstate = {"S": torch.from_numpy(S0), "x_tmix": torch.from_numpy(xt).to(torch.bfloat16),
              "x_cmix": torch.from_numpy(xc).to(torch.bfloat16)}
    x = _x((2, 1, jcfg.d_model), 24)
    for step in range(3):
        jy, jstate = jrwkv6.fwd_tmix_decode(jt, jcfg, JPOLICY, jnp.asarray(x), jstate)
        ty, tstate = trwkv6.fwd_tmix_decode(tt, tcfg, TEST_POLICY, torch.from_numpy(x), tstate)
        _close(ty, jy, err_msg=f"tmix step {step}", **TOL)
        jz, jstate = jrwkv6.fwd_cmix_decode(jc, jcfg, JPOLICY, jy, jstate)
        tz, tstate = trwkv6.fwd_cmix_decode(tc, tcfg, TEST_POLICY, ty, tstate)
        _close(tz, jz, err_msg=f"cmix step {step}", **TOL)
        _assert_state_close(tstate, jstate, f"step {step}")
        x = np.array(jz)


def test_rwkv6_cmix_full_matches_the_reference():
    jcfg, tcfg, jp, tp = _cmix_pair(4)
    x = _x((2, 12, jcfg.d_model), 25)
    _close(trwkv6.fwd_cmix_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x)),
           jrwkv6.fwd_cmix_full(jp, jcfg, JPOLICY, jnp.asarray(x)))


@pytest.mark.parametrize("C", [8, 16, 32])
def test_wkv_chunked_matches_the_reference_and_the_scan(C, monkeypatch):
    """The port's _wkv_chunked against the reference's on the same inputs,
    and fwd_tmix_full under WKV_CHUNK = C against the per-token loop (the
    reference's test_chunked_wkv_matches_scan, its tolerance); the prefill
    state under chunking is the loop's."""
    jcfg, tcfg, jp, tp = _tmix_pair(0)
    x = _x((2, 64, jcfg.d_model), 26, 0.5)
    r, k, v, _, w = trwkv6._wkv_inputs(tp, tcfg, TEST_POLICY, torch.from_numpy(x),
                                       trwkv6._shift(torch.from_numpy(x)))
    got = trwkv6._wkv_chunked(r, k, v, w, tp.u, C)
    want = jrwkv6._wkv_chunked(*(jnp.asarray(a.numpy()) for a in (r, k, v, w)), jp["u"], C)
    _close(got, want)
    scan = trwkv6.fwd_tmix_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    _, state = trwkv6.fwd_tmix_prefill(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    monkeypatch.setattr(trwkv6, "WKV_CHUNK", C)
    chunked = trwkv6.fwd_tmix_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    _close(chunked, scan.numpy())
    _, cstate = trwkv6.fwd_tmix_prefill(tp, tcfg, TEST_POLICY, torch.from_numpy(x))
    assert torch.equal(cstate["S"], state["S"])


# -------------------------------------------------------------- layer groups


def _models(arch, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    params = jmodel.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, params, lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                                    device="cpu")


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_apply_group_full_prefill_and_decode_match_the_reference(arch):
    """Group 1 of the reduced jamba (the 8-layer pattern: Mamba, attention at
    position 4, MoE at the odd positions) and rwkv6: full, prefill (output
    and every layer's state), then three decode steps from that cache."""
    jcfg, tcfg, jparams, tm = _models(arch)
    jgroup = jax.tree.map(lambda a: a[1], jparams["groups"])
    tgroup = tm.groups[1]
    B, S = 2, 16
    x = _x((B, S, jcfg.d_model), 30)
    pos = np.tile(np.arange(S), (B, 1))
    want, jaux = jtransformer.apply_group_full(jgroup, jcfg, JPOLICY, jnp.asarray(x),
                                               jnp.asarray(pos))
    with torch.no_grad():
        got, aux = ttransformer.apply_group_full(tgroup, tcfg, TEST_POLICY, torch.from_numpy(x),
                                                 torch.as_tensor(pos))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)

    jy, jcache = jtransformer.apply_group_prefill(jgroup, jcfg, JPOLICY, jnp.asarray(x),
                                                  jnp.asarray(pos))
    with torch.inference_mode():
        ty, tcache = ttransformer.apply_group_prefill(tgroup, tcfg, TEST_POLICY,
                                                      torch.from_numpy(x), torch.as_tensor(pos))
    _close(ty, jy)
    for name, c in jcache.items():
        _assert_state_close(tcache[name], c, f"prefill {name}")

    tcache = serve.grow_cache([tcache], S + 3)[0]
    jcache = {name: ({k: jnp.pad(a, ((0, 0), (0, 3), (0, 0), (0, 0))) for k, a in c.items()}
                     if "k" in c else c) for name, c in jcache.items()}
    for i in range(3):
        xs = _x((B, 1, jcfg.d_model), 31 + i)
        jy, jcache = jtransformer.apply_group_decode(jgroup, jcfg, JPOLICY, jnp.asarray(xs),
                                                     jcache, jnp.asarray(S + i, jnp.int32))
        with torch.inference_mode():
            ty, tcache = ttransformer.apply_group_decode(tgroup, tcfg, TEST_POLICY,
                                                         torch.from_numpy(xs), tcache, S + i)
        _close(ty, jy, err_msg=f"decode step {i}", **TOL)
        for name, c in jcache.items():
            _assert_state_close(tcache[name], c, f"decode {i} {name}")


def test_init_group_cache_matches_the_reference():
    for arch in (JAMBA, RWKV):
        jcfg, tcfg = _cfgs(arch)
        want = jtransformer.init_group_cache(jcfg, 2, 10)
        got = ttransformer.init_group_cache(tcfg, 2, 10, device="cpu")
        assert set(got) == set(want)
        for layer, c in want.items():
            assert set(got[layer]) == set(c)
            for name, a in c.items():
                assert tuple(got[layer][name].shape) == a.shape, (arch, layer, name)
                assert str(got[layer][name].dtype).endswith(str(a.dtype)), (arch, layer, name)


def test_grow_cache_grows_only_attention_k_v():
    """serve.grow_cache pads the attention layer's k, v to max_len and hands
    every SSM state over untouched (the same tensors), as the reference
    launcher pads only the 5-d k, v leaves."""
    _, tcfg, _, tm = _models(JAMBA)
    toks = torch.from_numpy(np.random.default_rng(40).integers(
        1, tcfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.inference_mode():
        _, cache = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, {"tokens": toks})
    grown = serve.grow_cache(cache, 20)
    for g, group in enumerate(cache):
        for layer, c in group.items():
            for name, a in c.items():
                b = grown[g][layer][name]
                if name in ("k", "v"):
                    assert b.shape[1] == 20 and torch.equal(b[:, :12], a) and not b[:, 12:].any()
                else:
                    assert b is a, (layer, name)
    q = serve.prefill(tm, tcfg, TEST_POLICY, {"tokens": toks}, 20, kv_int8=True)[1]
    assert q[0]["layer4"]["k"].dtype == torch.int8 and "k_scale" in q[0]["layer4"]
    assert q[0]["layer0"]["h"].dtype == torch.float32 and set(q[0]["layer0"]) == {"h", "conv"}


def test_rwkv6_padded_heads_exactness():
    """A model with more padded wkv heads computes the same function: the
    weights of a model with 4 physical heads (none padded) embedded into 6,
    the padded heads' wo rows, u, decay and norm bias filled with junk that
    the mask must hide."""
    _, base, _, tu = _models(RWKV, num_heads=4)
    padded = dataclasses.replace(base, padded_heads=6)
    assert (base.phys_heads, padded.phys_heads) == (4, 6)
    tp = tmodel.build(padded, TEST_POLICY, "cpu")
    a = base.phys_heads * base.rwkv_head_size
    junk = torch.Generator().manual_seed(41)
    src = dict(tu.named_parameters())
    with torch.no_grad():
        for name, p in tp.named_parameters():
            s = src[name]
            if tuple(p.shape) == tuple(s.shape):
                p.copy_(s)
                continue
            p.copy_(torch.randn(p.shape, generator=junk))
            if name.endswith(("wr", "wk", "wv", "wg", "wB")):  # (., a): padded columns zero
                p[:, a:] = 0.0
                p[:, :a] = s
            elif name.endswith("mixer.wo"):
                p[:a] = s
            elif name.endswith("mixer.u"):
                p[:base.phys_heads] = s
            else:  # w0, ln_scale, ln_bias (a,)
                p[:a] = s
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, base.vocab_size, (2, 10)).astype(np.int32))
    with torch.inference_mode():
        lu, cu = serve.prefill(tu, base, TEST_POLICY, {"tokens": toks}, 11)
        lp, cp = serve.prefill(tp, padded, TEST_POLICY, {"tokens": toks}, 11)
        np.testing.assert_allclose(lp.numpy(), lu.numpy(), rtol=1e-5, atol=1e-6)
        step = {"tokens": toks[:, -1:]}
        du, _ = tmodel.forward_decode(tu, base, TEST_POLICY, step, cu, 10)
        dp, _ = tmodel.forward_decode(tp, padded, TEST_POLICY, step, cp, 10)
        np.testing.assert_allclose(dp.numpy(), du.numpy(), rtol=1e-5, atol=1e-6)


def test_serve_main_rwkv6_on_cpu(capsys):
    from repro_torch.kernels import flash_attention as t_flash

    before = t_flash.launches
    out = serve.main(["--device", "cpu", "--arch", RWKV, "--batch", "2", "--prompt-len", "8",
                      "--gen", "3"])
    assert out.shape == (2, 3) and t_flash.launches == before
    assert f"[serve] {RWKV}-smoke on cpu" in capsys.readouterr().out
