"""The port's LM serving path against the JAX package's.

Weights cross over through ``convert.lm_params_from_numpy`` (torch and
jax.random draws differ by construction); inputs are numpy draws handed to
both. Everything runs on the CPU at reduced widths, where the port's prefill
attention is the plain version of ``flash_attention_bhsd``.

Tolerances: logits rtol 1e-4 / atol 1e-5. The bf16 KV caches are compared
bit for bit, allowing one bf16 ulp: XLA's and torch's f32 cos / sin (RoPE)
and matrix products round differently in the last f32 place, and where such
a value sits at a bf16 rounding boundary it rounds to the neighbouring bf16
value; the check allows that on at most 1 % of the elements.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.data import tokens as jtokens
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.models import rope as jrope
from repro.models.common import TEST_POLICY as JPOLICY
from repro.train import step as jstep
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import tokens as ttokens
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.launch import serve
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.models.common import TEST_POLICY

TOL = dict(rtol=1e-4, atol=1e-5)
# reduced dense configs: qkv bias + tied head; GQA; qk-norm + GQA; a sliding window
DENSE = [("qwen1.5-0.5b", 0), ("llama3-8b", 0), ("qwen3-4b", 0), ("qwen3-4b", 4)]
DENSE_IDS = [f"{a}-w{w}" for a, w in DENSE]


def _cfgs(arch, window=0, **overrides):
    j = dataclasses.replace(jreduced(jget_arch(arch)), sliding_window=window, **overrides)
    t = dataclasses.replace(reduced(get_arch(arch)), sliding_window=window, **overrides)
    return j, t


def _models(arch, window=0, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, window, **overrides)
    params = jmodel.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, lm_params_from_numpy(tree, tcfg, device="cpu")


def _bits(x) -> np.ndarray:
    """bf16 payload bits as int32."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(x).view(np.uint16).astype(np.int32)


def _assert_bf16_equal(got, want, what):
    """Bit for bit, or one bf16 ulp apart on at most 1 % of the elements."""
    a, b = _bits(got), _bits(want)
    diff = np.abs(a - b)
    assert diff.max() <= 1, f"{what}: differs by {diff.max()} bf16 ulps"
    assert (diff > 0).mean() <= 0.01, f"{what}: {(diff > 0).sum()} of {diff.size} differ"


def _jgrow(cache, max_len):
    def grow(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("k", "v"):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, max_len - x.shape[2])
            return jnp.pad(x, pad)
        return x

    return jax.tree_util.tree_map_with_path(grow, cache)


# ---------------------------------------------------------------- components


def test_rms_norm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tcommon.rms_norm(xb, torch.from_numpy(scale), 1e-6).dtype == torch.bfloat16

    pos = np.arange(37)
    for hd, theta in ((16, 1e6), (128, 5e5)):
        jc, js = jrope.rope_angles(jnp.asarray(pos), hd, theta)
        tc, ts = trope.rope_angles(torch.as_tensor(pos), hd, theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-7)
        xr = rng.standard_normal((1, 37, 3, hd)).astype(np.float32)
        np.testing.assert_allclose(
            trope.apply_rope(torch.from_numpy(xr), tc[None], ts[None]).numpy(),
            np.asarray(jrope.apply_rope(jnp.asarray(xr), jc[None], js[None])), **TOL)

    p = np.asarray(jcommon.sinusoidal_positions(jnp.arange(9), 32))
    np.testing.assert_allclose(tcommon.sinusoidal_positions(torch.arange(9), 32).numpy(), p,
                               rtol=0, atol=1e-6)

    for arch in ("qwen1.5-0.5b", "musicgen-large"):  # swiglu, gelu
        jcfg, tcfg = _cfgs(arch)
        jp = jmlp.init(jax.random.PRNGKey(1), jcfg, JPOLICY)
        tp = tmlp.MLP(tcfg, TEST_POLICY)
        for name in ("wi", "wo"):
            getattr(tp, name).copy_(torch.from_numpy(np.array(jp[name])))
        np.testing.assert_allclose(
            tmlp.apply(tp, tcfg, TEST_POLICY, torch.from_numpy(x)).numpy(),
            np.asarray(jmlp.apply(jp, jcfg, JPOLICY, jnp.asarray(x))), **TOL)


def _attention_pair(arch, window=0, seed=3):
    """One attention layer in both packages, from the same numpy weights
    (biases and qk-norm scales random, so they are exercised)."""
    jcfg, tcfg = _cfgs(arch, window)
    jp = jattention.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
              if k.startswith(("b", "q_", "k_")) else v) for k, v in jp.items()}
    tp = tattention.Attention(tcfg, TEST_POLICY)
    assert {n for n, _ in tp.named_parameters()} == set(jp)
    for name, value in jp.items():
        getattr(tp, name).copy_(torch.from_numpy(np.array(value)))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", 0), ("qwen3-4b", 0), ("qwen3-4b", 5),
                                         ("llama3-8b", 0)])
def test_attention_fwd_full_matches_jax(arch, window):
    jcfg, tcfg, jp, tp = _attention_pair(arch, window)
    x = np.random.default_rng(4).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    want = jattention.fwd_full(jp, jcfg, JPOLICY, jnp.asarray(x), jnp.asarray(pos))
    got = tattention.fwd_full(tp, tcfg, TEST_POLICY, torch.from_numpy(x), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_group_full_matches_jax():
    """One whole layer group (norms, attention, MLP, residuals), no cache."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer

    jcfg, tcfg, jparams, tm = _models("qwen3-4b", 6)
    jgroup = jax.tree.map(lambda a: a[1], jparams["groups"])
    x = np.random.default_rng(10).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20), (2, 1))
    want, _ = jtransformer.apply_group_full(jgroup, jcfg, JPOLICY, jnp.asarray(x),
                                            jnp.asarray(pos))
    got, aux = ttransformer.apply_group_full(tm.groups[1], tcfg, TEST_POLICY,
                                             torch.from_numpy(x), torch.as_tensor(pos))
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantize_kv_bitwise_equal():
    x = (np.random.default_rng(5).standard_normal((2, 9, 3, 16)) * 0.3).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    jq, js = jattention._quantize_kv(jnp.asarray(x))
    tq, ts = tattention._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattention._dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jattention._dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", 0), ("qwen3-4b", 0), ("qwen3-4b", 4)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_attention_fwd_decode_matches_jax(arch, window, kv):
    jcfg, tcfg, jp, tp = _attention_pair(arch, window)
    B, T, cl = 2, 20, 13
    rng = np.random.default_rng(6)
    shape = (B, T, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    k0, v0 = ((rng.standard_normal(shape) * 0.3).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    if kv == "bf16":
        jcache = {"k": jnp.asarray(k0).astype(jnp.bfloat16),
                  "v": jnp.asarray(v0).astype(jnp.bfloat16)}
        tcache = {"k": torch.from_numpy(k0).to(torch.bfloat16),
                  "v": torch.from_numpy(v0).to(torch.bfloat16)}
    else:
        jcache = jattention.quantize_cache({"k": jnp.asarray(k0), "v": jnp.asarray(v0)})
        tcache = tattention.quantize_cache({"k": torch.from_numpy(k0), "v": torch.from_numpy(v0)})
    y_want, c_want = jattention.fwd_decode(jp, jcfg, JPOLICY, jnp.asarray(x), jcache,
                                           jnp.asarray(cl, jnp.int32))
    y_got, c_got = tattention.fwd_decode(tp, tcfg, TEST_POLICY, torch.from_numpy(x), tcache, cl)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **TOL)
    for name in ("k", "v"):
        if kv == "bf16":
            _assert_bf16_equal(c_got[name], c_want[name], f"cache {name}")
        else:
            got, want = c_got[name].numpy(), np.asarray(c_want[name])
            others = np.arange(T) != cl
            np.testing.assert_array_equal(got[:, others], want[:, others])
            assert np.abs(got[:, cl].astype(int) - want[:, cl].astype(int)).max() <= 1
            np.testing.assert_allclose(c_got[name + "_scale"].numpy(),
                                       np.asarray(c_want[name + "_scale"]), rtol=1e-6)


# ---------------------------------------------------------------- whole model


@pytest.mark.parametrize("arch,window", DENSE, ids=DENSE_IDS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, window):
    jcfg, tcfg, jparams, tm = _models(arch, window)
    B, S, steps = 2, 16, 8
    rng = np.random.default_rng(7)
    toks = rng.integers(1, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    jl, jcache = jmodel.forward_prefill(jparams, jcfg, JPOLICY,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    with torch.inference_mode():
        tl, tcache = tmodel.forward_prefill(tm, tcfg, TEST_POLICY,
                                            {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tcache) == tcfg.num_groups
    for g, group in enumerate(tcache):
        for name in ("k", "v"):
            assert group["layer0"][name].dtype == torch.bfloat16
            _assert_bf16_equal(group["layer0"][name], jcache["layer0"][name][g],
                               f"prefill cache {g} {name}")

    jcache = _jgrow(jcache, S + steps)
    tcache = serve.grow_cache(tcache, S + steps)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, JPOLICY))
    for i in range(steps):
        step = toks[:, S + i:S + i + 1]
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(step)}, jcache,
                             jnp.asarray(S + i, jnp.int32))
        with torch.inference_mode():
            tl, tcache = tmodel.forward_decode(tm, tcfg, TEST_POLICY,
                                               {"tokens": torch.from_numpy(step)}, tcache, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {i}")
    for g, group in enumerate(tcache):
        for name in ("k", "v"):
            _assert_bf16_equal(group["layer0"][name], jcache["layer0"][name][g],
                               f"decoded cache {g} {name}")


def test_generate_greedy_matches_jax_loop():
    """serve.generate's greedy tokens against a reference prefill + decode
    loop: equal, except from a step where the reference's top-2 logits are
    closer than the tolerance (a near tie either side may break)."""
    jcfg, tcfg, jparams, tm = _models("qwen1.5-0.5b", seed=1)
    B, S, gen = 3, 12, 10
    toks = ttokens.synthetic_batch(tcfg, 0, B, S)["tokens"]
    res = serve.generate(tm, tcfg, TEST_POLICY, {"tokens": torch.from_numpy(toks)}, gen)
    assert res.tokens.shape == (B, gen) and res.logits.shape == (gen + 1, B, tcfg.vocab_size)

    jl, jcache = jmodel.forward_prefill(jparams, jcfg, JPOLICY, {"tokens": jnp.asarray(toks)})
    jcache = _jgrow(jcache, S + gen)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, JPOLICY))
    want, logits = [], [np.asarray(jl)]
    nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    for i in range(gen):
        want.append(np.asarray(nxt))
        jl, jcache = jdecode(jparams, {"tokens": nxt[:, None]}, jcache,
                             jnp.asarray(S + i, jnp.int32))
        logits.append(np.asarray(jl))
        nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = np.stack(want, axis=1)
    got = res.tokens.numpy()
    for i in range(gen):
        if np.array_equal(got[:, i], want[:, i]):
            np.testing.assert_allclose(res.logits[i].numpy(), logits[i], **TOL)
            continue
        top2 = np.sort(logits[i], axis=-1)[:, -2:]
        rows = got[:, i] != want[:, i]
        gap = top2[rows, 1] - top2[rows, 0]
        assert (gap <= TOL["atol"] + TOL["rtol"] * np.abs(top2[rows, 1])).all(), (i, gap)
        break


def test_generate_kv_int8_and_temperature():
    _, tcfg, _, tm = _models("qwen3-4b", seed=2)
    toks = torch.from_numpy(ttokens.synthetic_batch(tcfg, 1, 2, 9)["tokens"])
    fp = serve.generate(tm, tcfg, TEST_POLICY, {"tokens": toks}, 6)
    q8 = serve.generate(tm, tcfg, TEST_POLICY, {"tokens": toks}, 6, kv_int8=True)
    assert float((fp.logits[0] - q8.logits[0]).abs().max()) == 0.0  # prefill is not quantized
    assert float((fp.logits - q8.logits).abs().max()) < 2e-2
    draws = [serve.generate(tm, tcfg, TEST_POLICY, {"tokens": toks}, 6, temperature=0.8,
                            generator=torch.Generator().manual_seed(9)).tokens
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])  # the draws come from the generator
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch,window", DENSE, ids=DENSE_IDS)
def test_decode_matches_full_prefill(arch, window):
    """The reference's decode-vs-full check on the port: prefill S - 1 tokens,
    decode the last one, against the last logits of a full prefill."""
    _, tcfg, _, tm = _models(arch, window)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, {"tokens": toks})
        _, cache = serve.prefill(tm, tcfg, TEST_POLICY, {"tokens": toks[:, :-1]}, 16)
        step, _ = tmodel.forward_decode(tm, tcfg, TEST_POLICY, {"tokens": toks[:, -1:]}, cache, 15)
    assert float((full - step).abs().max()) < 2e-3


def test_padded_heads_exactness():
    """A model with padded heads (zero-init + masked) computes the same
    function: embed the unpadded weights into the padded layout."""
    _, base, _, tu = _models("llama3-8b")  # heads 4, kv 1 after reduction
    padded = dataclasses.replace(base, padded_heads=8)
    tp = tmodel.build(padded, TEST_POLICY, "cpu")
    KV, Dh, d = base.num_kv_heads, base.resolved_head_dim, base.d_model
    G, Gp = base.num_heads // KV, 8 // KV
    params_u = dict(tu.named_parameters())
    for name, p in tp.named_parameters():
        src = params_u[name]
        if name.endswith("mixer.wq"):  # (d, H, Dh) -> (d, Hp, Dh), real heads at g < G
            p.zero_()
            p.view(d, KV, Gp, Dh)[:, :, :G] = src.view(d, KV, G, Dh)
        elif name.endswith("mixer.wo"):  # (H, Dh, d) -> (Hp, Dh, d)
            p.zero_()
            p.view(KV, Gp, Dh, d)[:, :G] = src.view(KV, G, Dh, d)
        else:
            p.copy_(src)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, base.vocab_size, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        lu, cu = serve.prefill(tu, base, TEST_POLICY, {"tokens": toks}, 17)
        lp, cp = serve.prefill(tp, padded, TEST_POLICY, {"tokens": toks}, 17)
        np.testing.assert_allclose(lp.numpy(), lu.numpy(), rtol=1e-5, atol=1e-6)
        step = {"tokens": toks[:, -1:]}
        du, _ = tmodel.forward_decode(tu, base, TEST_POLICY, step, cu, 16)
        dp, _ = tmodel.forward_decode(tp, padded, TEST_POLICY, step, cp, 16)
        np.testing.assert_allclose(dp.numpy(), du.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llava-next-34b", "musicgen-large"])
def test_synthetic_batch_bitwise(arch):
    jcfg, tcfg = _cfgs(arch)
    for step in (0, 3):
        want = jtokens.synthetic_batch(jcfg, step, 3, 24)
        got = ttokens.synthetic_batch(tcfg, step, 3, 24)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_lm_params_from_numpy_checks_the_tree():
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY))
    m = lm_params_from_numpy(tree, tcfg, device="cpu")
    assert tmodel.param_count(m) == sum(int(x.size) for x in jax.tree.leaves(tree))
    np.testing.assert_array_equal(m.groups[1].layer0.mixer.wq.numpy(),
                                  tree["groups"]["layer0"]["mixer"]["wq"][1])
    extra = dict(tree, head=np.zeros((64, 256), np.float32))
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_numpy(extra, tcfg, device="cpu")
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(missing, tcfg, device="cpu")
    wrong = jax.tree.map(lambda x: x, tree)
    wrong["groups"]["layer0"]["ffn"]["wo"] = np.zeros((2, 100, 64), np.float32)
    with pytest.raises(ValueError, match="ffn.wo"):
        lm_params_from_numpy(wrong, tcfg, device="cpu")


def test_serve_main_on_cpu(capsys):
    before = t_flash.launches
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out.shape == (2, 3) and t_flash.launches == before
    assert "[serve] qwen1.5-0.5b-smoke on cpu" in capsys.readouterr().out
    mesh = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                       "--model-axis", "2"])  # a (1, 2) mesh: the sharded prefill and decode
    assert "[serve] qwen1.5-0.5b-smoke on a 1 x 2 mesh of cpu" in capsys.readouterr().out
    assert torch.equal(mesh, out) and t_flash.launches == before
