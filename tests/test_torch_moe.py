"""The port's MoE FFN against the JAX package's.

``moe.apply`` from the same numpy params and inputs: the output within
rtol 1e-5 / atol 1e-6 (f32 einsums summed in another order) and the aux loss
within rtol 1e-6, and the routing's integer bookkeeping (``ids``, ``pos``,
``keep``) exactly, read from the reference's own ``jax.lax.top_k`` and
``jax.nn.one_hot`` calls. Cases: plain routing, a router that sends every
token's first choice to one expert (capacity drops), two experts with equal
probabilities (ties go to the lower index, as ``lax.top_k`` breaks them), and
S == 1 (decode: the groups form across the batch). Then the reduced
mixtral-8x7b and qwen2-moe-a2.7b whole: ``forward_train``'s loss (rtol 1e-5)
and every gradient (max|diff| <= 1e-5 max|g| + 1e-7 a leaf), and prefill +
teacher-forced decode (logits rtol 1e-4 / atol 1e-5, the LM tests'
tolerance); and qwen2-moe-a2.7b's routing widths (60 experts, top-4, 4
shared) at a small d_model, where the reference's own decode-vs-full gap
is reproduced. Everything runs on the CPU.
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
from repro.models import moe as jmoe
from repro.models.common import TEST_POLICY as JPOLICY
from repro.train import step as jstep
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import TEST_POLICY

MOE_ARCHS = ["mixtral-8x7b", "qwen2-moe-a2.7b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch):
    return jreduced(jget_arch(arch)), reduced(get_arch(arch))


def _moe_pair(arch, router=None, seed=0):
    """The reference's MoE params (numpy) and the port's module holding them."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree.map(np.array, jmoe.init(jax.random.PRNGKey(seed), jcfg, JPOLICY))
    if router is not None:
        params["router"] = router(params["router"])
    p = tmoe.MoE(tcfg, TEST_POLICY, "cpu")
    for name, value in params.items():
        getattr(p, name).copy_(torch.from_numpy(value))
    return jcfg, tcfg, params, p


def _reference_apply(params, jcfg, x, monkeypatch):
    """The reference's (out, aux) and its routing: ids from its lax.top_k
    call, pos from its second one_hot call (keep = pos < capacity)."""
    seen = {}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(a, k):
        vals, ids = top_k(a, k)
        seen["ids"] = np.asarray(ids)
        return vals, ids

    def spy_one_hot(a, n, **kw):
        seen.setdefault("one_hot", []).append((np.asarray(a), n))
        return one_hot(a, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    out, aux = jmoe.apply({k: jnp.asarray(v) for k, v in params.items()}, jcfg, JPOLICY,
                          jnp.asarray(x))
    monkeypatch.undo()
    pos, capacity = seen["one_hot"][1]
    return np.asarray(out), float(aux), seen["ids"], pos, capacity


def _one_expert(router):
    r = router.copy()
    # with positive inputs every first choice is expert 0, by ~6 logits: enough to
    # overflow its capacity, not so much that the other probabilities shrink to
    # where the two frameworks' exp order near-equal tiny values differently
    r[:, 0] += 0.08
    return r


def _tied(router):
    r = router.copy()
    r[:, 2] = r[:, 1]  # experts 1 and 2 always equally likely
    return r


CASES = {"plain": (None, (2, 16)), "drops": (_one_expert, (2, 16)), "ties": (_tied, (2, 16)),
         "decode": (None, (4, 1)), "decode_drops": (_one_expert, (6, 1))}


def _inputs(case, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.5 if case.endswith("drops") else x


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_the_reference(arch, case, monkeypatch):
    router, (B, S) = CASES[case]
    jcfg, tcfg, params, p = _moe_pair(arch, router)
    x = _inputs(case, (B, S, jcfg.d_model))
    want, want_aux, ids, pos, capacity = _reference_apply(params, jcfg, x, monkeypatch)
    got, aux = tmoe.apply(p, tcfg, TEST_POLICY, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)
    T = B * S
    G = min(tmoe.GROUP_SIZE, T)
    r = tmoe.route(p, tcfg, TEST_POLICY, torch.from_numpy(x).reshape(T // G, G, -1))
    assert r.capacity == capacity == tmoe._capacity(G, tcfg.moe.top_k, tcfg.moe.num_experts,
                                                     tmoe.CAPACITY_FACTOR)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), pos < capacity)
    if case.endswith("drops"):
        assert (ids[..., 0] == 0).all() and not r.keep.all()
    if case == "ties":
        first_two = np.sort(ids[..., :2], axis=-1)
        assert ((first_two == [1, 2]).all(axis=-1) | (ids[..., :2] != 2).all(axis=-1)).all()


def test_capacity_matches_the_reference():
    for group, k, e in ((256, 4, 60), (256, 2, 8), (2, 4, 60), (32, 2, 4), (1, 1, 1)):
        assert tmoe._capacity(group, k, e, 1.25) == jmoe._capacity(group, k, e, 1.25)


def test_moe_layers_build_init_and_match_the_reference_names():
    for arch in MOE_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        m = tmodel.init(torch.Generator().manual_seed(0), tcfg, TEST_POLICY, device="cpu")
        ffn = m.groups[0].layer0.ffn
        assert isinstance(ffn, tmoe.MoE)
        ref = jmoe.init(jax.random.PRNGKey(0), jcfg, JPOLICY)
        assert {n: tuple(t.shape) for n, t in ffn.named_parameters()} == {
            n: tuple(a.shape) for n, a in ref.items()}
        assert not any(t.requires_grad for t in m.parameters())  # built for serving
        tmodel.init_cache(tcfg, 1, 8, device="cpu")


def _models(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    params = jmodel.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, params, lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                                    device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_loss_and_grads_match_the_reference(arch):
    jcfg, tcfg, jparams, tm = _models(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.2).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, jcfg, JPOLICY, {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)})
    for p in tm.parameters():
        p.requires_grad_(True)
    tl, tmetrics = tmodel.forward_train(tm, tcfg, TEST_POLICY, {
        "tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tmetrics["aux"].detach()) > 0
    np.testing.assert_allclose(float(tmetrics["aux"].detach()), float(jm["aux"]), rtol=1e-5)
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))
    want = dict(lm_params_from_numpy(jax.tree.map(np.asarray, jg), tcfg,
                                     device="cpu").named_parameters())
    for name, g in grads.items():
        w = want[name].numpy()
        bound = 1e-5 * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= bound, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_teacher_forced_decode_match_the_reference(arch):
    jcfg, tcfg, jparams, tm = _models(arch, seed=1)
    B, S, steps = 2, 16, 6
    toks = np.random.default_rng(3).integers(1, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    jl, jcache = jmodel.forward_prefill(jparams, jcfg, JPOLICY,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    with torch.inference_mode():
        tl, tcache = serve.prefill(tm, tcfg, TEST_POLICY,
                                   {"tokens": torch.from_numpy(toks[:, :S])}, S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def grow(path, x):
        if str(getattr(path[-1], "key", "")) in ("k", "v"):
            return jnp.pad(x, [(0, 0), (0, 0), (0, steps)] + [(0, 0)] * (x.ndim - 3))
        return x

    jcache = jax.tree_util.tree_map_with_path(grow, jcache)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, JPOLICY))
    for i in range(steps):
        step = toks[:, S + i:S + i + 1]
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(step)}, jcache,
                             jnp.asarray(S + i, jnp.int32))
        with torch.inference_mode():
            tl, tcache = tmodel.forward_decode(tm, tcfg, TEST_POLICY,
                                               {"tokens": torch.from_numpy(step)}, tcache, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's decode-vs-full check (tests/test_models_smoke.py) on
    the port, with its MoE bound: capacity drops depend on the group."""
    _, tcfg, _, tm = _models(arch)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, {"tokens": toks})
        _, cache = serve.prefill(tm, tcfg, TEST_POLICY, {"tokens": toks[:, :-1]}, 16)
        step, _ = tmodel.forward_decode(tm, tcfg, TEST_POLICY, {"tokens": toks[:, -1:]}, cache, 15)
    assert float((full - step).abs().max()) < 5e-2


def test_apply_group_full_sums_the_aux_loss():
    jcfg, tcfg, jparams, tm = _models("mixtral-8x7b")
    from repro.models import transformer as jtransformer

    x = np.random.default_rng(5).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(16), (2, 1))
    want, want_aux = jtransformer.apply_group_full(
        jax.tree.map(lambda a: a[0], jparams["groups"]), jcfg, JPOLICY, jnp.asarray(x),
        jnp.asarray(pos))
    got, aux = ttransformer.apply_group_full(tm.groups[0], tcfg, TEST_POLICY,
                                             torch.from_numpy(x), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert dataclasses.replace(tcfg).layer_pattern()[0].ffn == "moe"


def _wide_routing_cfgs():
    """qwen2-moe-a2.7b's routing widths (60 experts, top-4, 4 shared) at a
    small d_model and vocab."""
    import dataclasses as dc

    over = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                vocab_size=512)
    out = []
    for get in (jget_arch, get_arch):
        c = dc.replace(get("qwen2-moe-a2.7b"), **over)
        out.append(dc.replace(c, moe=dc.replace(c.moe, d_ff_expert=64, d_ff_shared=64)))
    return out


def test_sixty_experts_top_four_match_the_reference(monkeypatch):
    """At the routing widths of qwen2-moe-a2.7b: prefill logits within the LM
    tolerance, and the reference's decode-vs-full gap reproduced (the full
    forward's group of 256 tokens drops other (token, choice) pairs than a
    decode step's group of 2), within 1e-4 of it; with the capacity factor
    raised to E / k, where nothing is dropped, the gap falls under 2e-3."""
    jcfg, tcfg = _wide_routing_cfgs()
    params = jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 128)).astype(np.int32)
    jfull, _ = jmodel.forward_prefill(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks)})
    _, jcache = jmodel.forward_prefill(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks[:, :-1])})
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.pad(x, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
        if str(getattr(path[-1], "key", "")) in ("k", "v") else x, jcache)
    jstep_logits, _ = jmodel.forward_decode(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks[:, -1:])},
                                            jcache, jnp.asarray(127, jnp.int32))
    want_gap = float(jnp.max(jnp.abs(jfull - jstep_logits)))

    def port_gap():
        with torch.inference_mode():
            full, _ = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, {"tokens": torch.from_numpy(toks)})
            _, cache = serve.prefill(tm, tcfg, TEST_POLICY,
                                     {"tokens": torch.from_numpy(toks[:, :-1])}, 128)
            step, _ = tmodel.forward_decode(tm, tcfg, TEST_POLICY,
                                            {"tokens": torch.from_numpy(toks[:, -1:])}, cache, 127)
        return full, float((full - step).abs().max())

    full, gap = port_gap()
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)
    assert abs(gap - want_gap) <= 1e-4, (gap, want_gap)
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", 60 / 4)
    assert port_gap()[1] < 2e-3
