"""The four archs that the SSM mixers and the frontends bring to the port,
whole, against the JAX package: jamba-1.5-large-398b (Mamba + attention +
MoE), rwkv6-3b (RWKV6), musicgen-large (audio codes: K codebook embeddings
summed, K heads) and llava-next-34b (a vision prefix of patch embeddings).

Params cross over through ``convert.lm_params_from_numpy`` from the
reference's init; inputs are numpy draws handed to both. Everything runs on
the CPU at reduced widths. Tolerances: logits rtol 1e-4 / atol 1e-5 (those
of tests/test_torch_lm.py); ``forward_train``'s loss within rtol 1e-5 and
each gradient leaf within 1e-5 max|g| + 1e-7 (those of
tests/test_torch_train.py); decode against the full forward at the
reference's bars, 2e-3, and 5e-2 for MoE (tests/test_models_smoke.py);
bf16 caches bit for bit or one bf16 ulp apart on at most 1 % of the
elements.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro.models.common import TEST_POLICY as JPOLICY
from repro.optim import adamw as jadamw
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data import tokens as ttokens
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.common import TEST_POLICY
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["jamba-1.5-large-398b", "rwkv6-3b", "musicgen-large", "llava-next-34b"]


def _models(arch, seed=0):
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    params = jmodel.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, params, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                            tcfg, device="cpu")


def _batch(cfg, B, S, seed, mask=False):
    """Model inputs of S positions: tokens, codes (B, K, S), or P patch
    embeddings and S - P tokens; with ``mask`` a random loss mask, zero at
    the prefix."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_codes":
        out["codes"] = rng.integers(0, cfg.vocab_size, (B, cfg.num_codebooks, S)).astype(np.int32)
    elif cfg.frontend == "vision_prefix":
        P = cfg.num_prefix_tokens
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - P)).astype(np.int32)
        out["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if mask:
        m = (rng.random((B, S)) > 0.2).astype(np.float32)
        m[:, :cfg.num_prefix_tokens] = 0.0
        out["loss_mask"] = m
    return out


def _split(cfg, batch, n):
    """(prefill inputs, [decode step inputs]): the last n positions become
    decode steps (text tokens or codes; the prefix stays in the prefill)."""
    if cfg.frontend == "audio_codes":
        codes = batch["codes"]
        return {"codes": codes[:, :, :-n]}, [{"codes": codes[:, :, i:i + 1]}
                                             for i in range(codes.shape[2] - n, codes.shape[2])]
    pre = dict(batch, tokens=batch["tokens"][:, :-n])
    toks = batch["tokens"]
    return pre, [{"tokens": toks[:, i:i + 1]} for i in range(toks.shape[1] - n, toks.shape[1])]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jgrow(cache, max_len):
    def grow(path, x):
        if str(getattr(path[-1], "key", "")) in ("k", "v"):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, max_len - x.shape[2])
            return jnp.pad(x, pad)
        return x

    return jax.tree_util.tree_map_with_path(grow, cache)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(x).view(np.uint16).astype(np.int32)


def _assert_cache_close(tcache, jcache, what):
    """The port's per-group caches against the reference's stacked one."""
    for g, group in enumerate(tcache):
        assert set(group) == set(jcache)
        for layer, c in group.items():
            assert set(c) == set(jcache[layer])
            for name, a in c.items():
                want = np.asarray(jcache[layer][name][g])
                if want.dtype == jnp.bfloat16:
                    diff = np.abs(_bits(a) - _bits(want))
                    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (what, layer, name)
                else:
                    np.testing.assert_allclose(a.numpy(), want, **TOL,
                                               err_msg=f"{what} {g} {layer} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_the_reference(arch):
    jcfg, tcfg, jparams, tm = _models(arch)
    B, S, steps = 2, 24, 6
    pre, dec = _split(tcfg, _batch(tcfg, B, S, 1), steps)
    jl, jcache = jmodel.forward_prefill(jparams, jcfg, JPOLICY, _j(pre))
    with torch.inference_mode():
        tl, tcache = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, _t(pre))
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tcache, jcache, "prefill")

    P = S - steps
    jcache = _jgrow(jcache, S)
    tcache = serve.grow_cache(tcache, S)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, JPOLICY))
    for i, step in enumerate(dec):
        jl, jcache = jdecode(jparams, _j(step), jcache, jnp.asarray(P + i, jnp.int32))
        with torch.inference_mode():
            tl, tcache = tmodel.forward_decode(tm, tcfg, TEST_POLICY, _t(step), tcache, P + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {i}")
    _assert_cache_close(tcache, jcache, "decoded")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_the_reference_loop(arch):
    """serve.generate's greedy tokens (one code a codebook for audio) against
    a reference prefill + decode loop: equal, except from a step where the
    reference's top-2 logits are closer than the tolerance."""
    jcfg, tcfg, jparams, tm = _models(arch, seed=1)
    B, S, gen = 2, 16, 6
    batch = {k: v for k, v in ttokens.synthetic_batch(tcfg, 0, B, S).items() if k != "loss_mask"}
    res = serve.generate(tm, tcfg, TEST_POLICY, _t(batch), gen)
    audio = tcfg.frontend == "audio_codes"

    jl, jcache = jmodel.forward_prefill(jparams, jcfg, JPOLICY, _j(batch))
    jcache = _jgrow(jcache, S + gen)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, JPOLICY))
    want, logits = [], [np.asarray(jl)]
    nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    for i in range(gen):
        want.append(np.asarray(nxt))
        step = {"codes": nxt[:, :, None]} if audio else {"tokens": nxt[:, None]}
        jl, jcache = jdecode(jparams, step, jcache, jnp.asarray(S + i, jnp.int32))
        logits.append(np.asarray(jl))
        nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = np.stack(want, axis=-1)
    got = res.tokens.numpy()
    assert got.shape == want.shape and tuple(res.logits.shape) == (gen + 1, *logits[0].shape)
    for i in range(gen):
        if np.array_equal(got[..., i], want[..., i]):
            np.testing.assert_allclose(res.logits[i].numpy(), logits[i], **TOL)
            continue
        top2 = np.sort(logits[i], axis=-1)[..., -2:]
        rows = got[..., i] != want[..., i]
        gap = top2[rows][:, 1] - top2[rows][:, 0]
        assert (gap <= TOL["atol"] + TOL["rtol"] * np.abs(top2[rows][:, 1])).all(), (i, gap)
        break


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_the_reference(arch):
    jcfg, tcfg, jparams, tm = _models(arch, seed=2)
    batch = _batch(tcfg, 2, 16, 3, mask=True)
    (jl, jm), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(jparams, jcfg, JPOLICY,
                                                                   _j(batch))
    for p in tm.parameters():
        p.requires_grad_(True)
    loss, metrics = tmodel.forward_train(tm, tcfg, TEST_POLICY, _t(batch))
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5, atol=1e-8)
    want = {n: p.detach() for n, p in convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu").named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        bound = 1e-5 * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= bound, (name, np.abs(g.numpy() - w).max(), bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's check on the port: prefill all but the last position,
    decode it, against the last logits of a full prefill."""
    _, tcfg, _, tm = _models(arch, seed=3)
    S = 16
    batch = _batch(tcfg, 2, S, 4)
    pre, (step,) = _split(tcfg, batch, 1)
    with torch.inference_mode():
        full, _ = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, _t(batch))
        _, cache = serve.prefill(tm, tcfg, TEST_POLICY, _t(pre), S)
        got, _ = tmodel.forward_decode(tm, tcfg, TEST_POLICY, _t(step), cache, S - 1)
    tol = 5e-2 if tcfg.moe is not None else 2e-3
    assert float((full - got).abs().max()) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips(arch):
    """The reference's params tree and an AdamW state through the port and
    back, bit for bit: the Mamba and RWKV6 trees and the (K, V, d) codebook
    embeddings and K heads included."""
    jcfg, tcfg, jparams, tm = _models(arch, seed=4)
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.lm_params_to_numpy(tm, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert tmodel.param_count(tm) == sum(x.size for x in jax.tree.leaves(tree))
    if tcfg.frontend == "audio_codes":
        assert tm.embed.shape == (4, tcfg.vocab_size, tcfg.d_model)
        assert tm.head.shape == (4, tcfg.d_model, tcfg.vocab_size)

    jst = jadamw.init(jparams, JAdamWConfig())
    jst = jadamw.AdamWState(jnp.asarray(3, jnp.int32),
                            jax.tree.map(lambda x: x + 1.0, jst.mu),
                            jax.tree.map(lambda x: x + 2.0, jst.nu))
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    assert set(state.mu) == set(dict(tm.named_parameters()))
    again = convert.adamw_state_to_numpy(state, tcfg)
    assert int(again.step) == 3
    for a, b in zip(jax.tree.leaves((again.mu, again.nu)), jax.tree.leaves((jst.mu, jst.nu))):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = adamw.init(tm, AdamWConfig())
    trees = convert.lm_train_state_to_numpy(tm, fresh, tcfg)
    assert jax.tree.structure(trees["params"]) == jax.tree.structure(tree)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_embed_inputs_and_labels_match_the_reference(arch):
    """The frontends: the summed codebook embeddings plus sinusoidal positions
    (musicgen), the patch embeddings ahead of the tokens (llava), and the
    labels the loss reads, zeros at the prefix."""
    jcfg, tcfg, jparams, tm = _models(arch, seed=5)
    batch = _batch(tcfg, 2, 16, 6)
    want = jmodel.embed_inputs(jparams, jcfg, JPOLICY, _j(batch))
    got = tmodel.embed_inputs(tm, tcfg, TEST_POLICY, _t(batch))
    # atol 1e-6: the sinusoidal table's, as tests/test_torch_lm.py holds it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert got.shape[1] == 16
    np.testing.assert_array_equal(tmodel._labels(tcfg, _t(batch)).numpy(),
                                  np.asarray(jmodel._labels(jcfg, _j(batch))))
    if tcfg.frontend == "vision_prefix":  # decode steps are text-only
        step = {"tokens": batch["tokens"][:, :1]}
        np.testing.assert_array_equal(
            tmodel.embed_inputs(tm, tcfg, TEST_POLICY, _t(step)).numpy(),
            np.asarray(jmodel.embed_inputs(jparams, jcfg, JPOLICY, _j(step))))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "musicgen-large", "llava-next-34b"])
def test_serve_main_on_cpu(arch, capsys):
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "12",
                      "--gen", "3"])
    cfg = reduced(get_arch(arch))
    assert tuple(out.shape) == ((2, cfg.num_codebooks, 3) if cfg.frontend == "audio_codes"
                                else (2, 3))
    assert f"[serve] {cfg.name} on cpu" in capsys.readouterr().out


def test_nothing_in_the_models_raises_not_implemented():
    """Every arch builds, and no model module names a layer left to port."""
    import inspect

    from repro_torch.configs import ALL_ARCHS
    from repro_torch.models import attention, common, mamba, mlp, moe, rope, rwkv6, transformer

    for arch in ALL_ARCHS:
        cfg = dataclasses.replace(reduced(get_arch(arch)), num_layers=len(
            reduced(get_arch(arch)).layer_pattern()))
        tmodel.build(cfg, TEST_POLICY, "cpu")
        tmodel.init_cache(cfg, 1, 4, device="cpu")
    for mod in (attention, common, mamba, mlp, moe, rope, rwkv6, transformer, tmodel):
        assert "NotImplementedError" not in inspect.getsource(mod), mod.__name__
