"""The port's LM training path against the JAX package's.

Params cross over through ``convert.lm_params_from_numpy``; tokens and masks
are numpy draws handed to both. Everything runs on the CPU at reduced widths,
where the port's attention is the plain version under autograd. Tolerances:

  * ``forward_train``'s loss within rtol 1e-5, and each gradient leaf within
    max|diff| <= 1e-5 max|g| + 1e-7 (the f32 products and sums of the two
    frameworks round differently; measured <= 7.2e-7 max|g|);
  * one ``make_train_step`` step from the reference's init: each parameter
    within 1e-6 + lr min(2, delta eps / (|g| + eps)^2), g the reference's
    clipped gradient and delta the gradient tolerance above. The first Adam
    step is g / (|g| + eps), whose slope eps / (|g| + eps)^2 magnifies a
    gradient difference of a few f32 places where |g| is near eps; elsewhere
    the bound is 1e-6;
  * a step taken from a checkpoint at step 10: each parameter within 1e-6,
    under 1 % of that step's learning rate (measured 1.8e-7): ten steps of
    history in the Adam denominators damp the gradients' last-place
    differences;
  * the ports of tests/test_train_loop.py and of the accumulation and
    schedule cases of tests/test_train_features.py keep their own bounds;
    crash and resume is bit for bit.
"""
import json
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.data import tokens as jtokens
from repro.distributed import checkpoint as jckpt
from repro.models import model as jmodel
from repro.models.common import TEST_POLICY as JPOLICY
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as jstep
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models.common import TEST_POLICY
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, TrainLoop

ARCHS = ["qwen1.5-0.5b", "llama3-8b", "qwen3-4b"]  # qkv bias + tied head; GQA; qk-norm


def _models(arch, seed=0, **overrides):
    import dataclasses

    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **overrides)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), **overrides)
    params = jmodel.init(jax.random.PRNGKey(seed), jcfg, JPOLICY)
    return jcfg, tcfg, params, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _batch(cfg, B=2, S=16, seed=2, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) > 0.2) if masked else np.ones((B, S))).astype(np.float32)
    return {"tokens": toks, "loss_mask": mask}


def _by_name(tree, tcfg) -> dict:
    """A reference params-shaped tree (params or grads) by the port's names."""
    return {n: p.detach() for n, p in convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), tcfg, device="cpu").named_parameters()}


def _loss_and_grads(tm, tcfg, batch):
    for p in tm.parameters():
        p.requires_grad_(True)
    loss, metrics = tmodel.forward_train(tm, tcfg, TEST_POLICY,
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(tm.named_parameters())
    return loss, metrics, dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        bound = 1e-5 * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= bound, (name, np.abs(g.numpy() - w).max(), bound)


# ------------------------------------------------------- forward_train and CE


@pytest.mark.parametrize("arch,remat", [(a, "full") for a in ARCHS] + [("qwen1.5-0.5b", "none")])
def test_forward_train_loss_and_grads_match_the_reference(arch, remat):
    jcfg, tcfg, jparams, tm = _models(arch, remat=remat)
    batch = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, jcfg, JPOLICY, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _loss_and_grads(tm, tcfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]), rtol=1e-5)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    _assert_grads_close(grads, _by_name(jg, tcfg))


def test_chunked_ce_ragged_tail_matches_the_reference(monkeypatch):
    """LOSS_CHUNK = 5 on both sides: S - 1 = 15 -> 3 x 5, and S = 18 leaves
    a ragged tail of 2."""
    import repro.models.model as jM

    jcfg, tcfg, jparams, tm = _models("qwen1.5-0.5b")
    monkeypatch.setattr(jM, "LOSS_CHUNK", 5)
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", 5)
    for S in (16, 18):
        batch = _batch(jcfg, S=S, seed=S)
        (jl, _), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
            jparams, jcfg, JPOLICY, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, _, grads = _loss_and_grads(tm, tcfg, batch)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        _assert_grads_close(grads, _by_name(jg, tcfg))


def test_chunked_ce_matches_direct(monkeypatch):
    """The memory-saving chunked CE == one chunk of the whole sequence."""
    _, tcfg, _, tm = _models("qwen1.5-0.5b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, masked=False).items()}
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", 5)  # a ragged tail: S - 1 = 15 -> 3 x 5
    l_chunked, _ = tmodel.forward_train(tm, tcfg, TEST_POLICY, batch)
    monkeypatch.undo()
    l_direct, _ = tmodel.forward_train(tm, tcfg, TEST_POLICY, batch)
    np.testing.assert_allclose(float(l_chunked), float(l_direct), rtol=1e-5)
    x = tmodel.embed_inputs(tm, tcfg, TEST_POLICY, batch)
    for group in tm.groups:
        x, _ = tmodel.transformer.apply_group_full(group, tcfg, TEST_POLICY, x,
                                                   torch.arange(16).expand(2, 16))
    x = tmodel.rms_norm(x, tm.final_norm, tcfg.norm_eps)
    logits = tmodel._head_logits(tm, tcfg, TEST_POLICY, x)[:, :-1]
    full = torch.nn.functional.cross_entropy(logits.reshape(-1, tcfg.vocab_size),
                                             batch["tokens"][:, 1:].reshape(-1).long())
    np.testing.assert_allclose(float(l_direct), float(full), rtol=1e-5)


def test_serving_params_stay_frozen_and_training_needs_no_flag():
    _, tcfg, _, tm = _models("qwen1.5-0.5b")
    assert not any(p.requires_grad for p in tm.parameters())
    opt_cfg = AdamWConfig(lr=1e-3)
    ts = tstep.make_train_step(tcfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    _, st, metrics = ts(tm, adamw.init(tm, opt_cfg), batch)
    assert all(p.requires_grad for p in tm.parameters()) and int(st.step) == 1
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert not metrics["loss"].requires_grad


# ------------------------------------------------------------- train step


@pytest.fixture
def one_thread():
    """One intra-op thread: the SSM archs' per-token scans are tiny ops, which
    a team of threads a test worker only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(arch, accum, request):
    """jamba's config keeps its moments in bf16, on both sides."""
    if arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        request.getfixturevalue("one_thread")
    jcfg, tcfg, jparams, tm = _models(arch)
    lr, scale = 1e-3, 0.5
    jopt_cfg = JAdamWConfig(lr=lr, moments_dtype=jcfg.moments_dtype)
    opt_cfg = AdamWConfig(lr=lr, moments_dtype=tcfg.moments_dtype)
    batch = _batch(jcfg, B=4, masked=False)
    jts = jax.jit(jstep.make_train_step(jcfg, JPOLICY, jopt_cfg, lambda s: scale, accum))
    jp2, jst, jm = jts(jparams, jadamw.init(jparams, jopt_cfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    ts = tstep.make_train_step(tcfg, TEST_POLICY, opt_cfg, lambda s: scale, accum)
    tm, st, m = ts(tm, adamw.init(tm, opt_cfg), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(st.step) == int(jst.step) == 1
    want = _by_name(jp2, tcfg)
    g = _by_name(jax.tree.map(lambda mu: mu.astype(jnp.float32) / (1 - jopt_cfg.b1), jst.mu),
                 tcfg)  # the clipped gradients (to bf16's precision for bf16 moments)
    eps = jopt_cfg.eps
    for name, p in tm.named_parameters():
        gn = g[name].abs().numpy()
        delta = 1e-5 * gn.max() + 1e-7
        bound = 1e-6 + lr * scale * np.minimum(2.0, delta * eps / (gn + eps) ** 2)
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert (diff <= bound).all(), (name, diff.max())


def _accum_setup(accum):
    """tests/test_train_features.py's _setup on the port."""
    cfg = reduced(get_arch("llama3-8b"))
    params = tmodel.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, grad_clip=0.0)  # clip off: it breaks linearity
    ts = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0, accum)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.ones((4, 16))}
    return ts, params, adamw.init(params, opt_cfg), batch


def test_grad_accumulation_matches_single_pass():
    ts1, p1, o1, batch = _accum_setup(1)
    ts2, p2, o2, _ = _accum_setup(2)
    p1, _, m1 = ts1(p1, o1, batch)
    p2, _, m2 = ts2(p2, o2, batch)
    # microbatch mean-of-means == full mean (equal microbatch sizes)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    b = dict(p2.named_parameters())
    worst = max(float((a - b[n]).abs().max().detach()) for n, a in p1.named_parameters())
    assert worst < 2e-5, worst


def test_schedule_modulates_update_size():
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.ones((2, 16))}

    def delta(lr_scale):
        params = tmodel.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
        before = {n: p.detach().clone() for n, p in params.named_parameters()}
        ts = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: lr_scale)
        params, _, _ = ts(params, adamw.init(params, opt_cfg), batch)
        return max(float((p.detach() - before[n]).abs().max())
                   for n, p in params.named_parameters())

    assert delta(1.0) > 5 * delta(0.1)


def test_schedule_is_read_at_the_optimizer_step():
    _, tcfg, _, tm = _models("qwen1.5-0.5b")
    seen = []
    opt_cfg = AdamWConfig(lr=1e-3)
    ts = tstep.make_train_step(tcfg, TEST_POLICY, opt_cfg, lambda s: seen.append(s) or 1.0)
    st = adamw.init(tm, opt_cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    for _ in range(3):
        tm, st, _ = ts(tm, st, batch)
    assert seen == [0, 1, 2]


def test_microbatches_must_split_evenly():
    _, tcfg, _, tm = _models("qwen1.5-0.5b")
    ts = tstep.make_train_step(tcfg, TEST_POLICY, AdamWConfig(), lambda s: 1.0, 3)
    with pytest.raises(ValueError, match="equal microbatches"):
        ts(tm, adamw.init(tm, AdamWConfig()), {k: torch.from_numpy(v)
                                               for k, v in _batch(tcfg, B=4).items()})


# -------------------------------------------- the cases of tests/test_train_loop.py


def quad_setup():
    """params -> scalar loss; a deterministic data stream."""
    target = torch.arange(4.0)

    def train_step(params, opt_state, batch):
        p = params.detach().requires_grad_(True)
        loss = torch.sum((p - target) ** 2) + 0.0 * torch.sum(batch)
        (g,) = torch.autograd.grad(loss, [p])
        return (p - 0.1 * g).detach(), opt_state, {"loss": loss.detach()}

    def data_factory(start):
        def gen():
            s = start
            while True:
                yield torch.full((2,), float(s))
                s += 1
        return gen()

    return train_step, data_factory


def run_loop(ckpt_dir, steps, fault_hook=None, ckpt_every=5):
    ts, df = quad_setup()
    loop = TrainLoop(ts, df, ckpt_dir,
                     LoopConfig(total_steps=steps, checkpoint_every=ckpt_every, log_every=1),
                     fault_hook=fault_hook)
    return loop, loop.run(torch.zeros((4,)), None)


def test_loop_descends_and_logs(tmp_path):
    _, (_, _, history) = run_loop(tmp_path / "ckpt", 20)
    assert history[-1]["loss"] < history[0]["loss"]
    lines = (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 10
    json.loads(lines[0])


class Boom(RuntimeError):
    pass


def _fault_once(marker: Path, at: int):
    def fault(step):
        if step == at and not marker.exists():
            marker.parent.mkdir(parents=True, exist_ok=True)
            marker.write_text("x")
            raise Boom()
    return fault


def test_crash_resume_equals_uninterrupted(tmp_path):
    """Kill at step 12 (checkpoint at 10), resume; params equal the run that
    never crashed, bit for bit."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    _, (p_ref, _, _) = run_loop(d1, 20)
    fault = _fault_once(d2 / "fired", 12)
    with pytest.raises(Boom):
        run_loop(d2, 20, fault_hook=fault)
    _, (p_resumed, _, _) = run_loop(d2, 20, fault_hook=fault)
    assert torch.equal(p_resumed, p_ref)


def test_straggler_watchdog_fires(tmp_path):
    ts, df = quad_setup()
    calls = {"n": 0}

    def slow_train_step(params, opt_state, batch):
        calls["n"] += 1
        if calls["n"] == 10:
            time.sleep(0.5)  # an injected straggler
        return ts(params, opt_state, batch)

    loop = TrainLoop(slow_train_step, df, tmp_path / "ckpt",
                     LoopConfig(total_steps=15, checkpoint_every=50, straggler_factor=3.0,
                                straggler_warmup=3))
    loop.run(torch.zeros((4,)), None)
    assert len(loop.straggler_events) >= 1
    ev = loop.straggler_events[0]
    assert ev.step_time > 3.0 * ev.median


def test_data_position_resumes(tmp_path):
    """The data iterator restarts exactly at the checkpointed step."""
    seen = []

    def train_step(params, opt_state, batch):
        seen.append(int(batch[0]))
        return params, opt_state, {"loss": torch.zeros(())}

    def data_factory(start):
        def gen():
            s = start
            while True:
                yield torch.full((1,), float(s))
                s += 1
        return gen()

    TrainLoop(train_step, data_factory, tmp_path / "c",
              LoopConfig(total_steps=6, checkpoint_every=3, log_every=1)).run(torch.zeros(()), None)
    seen.clear()
    TrainLoop(train_step, data_factory, tmp_path / "c",
              LoopConfig(total_steps=9, checkpoint_every=3, log_every=1)).run(torch.zeros(()), None)
    assert seen == [6, 7, 8]


# ------------------------------------------------------- the LM in the loop


def _lm_loop(tcfg, ckpt_dir, steps, ckpt_every, fault_hook=None, seed=0):
    model = tmodel.init(torch.Generator().manual_seed(seed), tcfg, TEST_POLICY, device="cpu")
    opt_cfg = AdamWConfig(lr=3e-3)
    ts = tstep.make_train_step(tcfg, TEST_POLICY, opt_cfg,
                               lambda s: warmup_cosine(s, warmup=2, total=steps))
    loop = TrainLoop(ts, lambda s: ttokens.batch_iterator(tcfg, 2, 16, s, "cpu"), ckpt_dir,
                     LoopConfig(total_steps=steps, checkpoint_every=ckpt_every, log_every=1),
                     fault_hook=fault_hook)
    return loop.run(model, adamw.init(model, opt_cfg))


def test_lm_crash_resume_is_bitwise(tmp_path):
    """The LM and its AdamW state through the reference-format checkpoint:
    crash at step 5 (checkpoint at 4), resume, equal the uninterrupted run."""
    tcfg = reduced(get_arch("llama3-8b"))
    p_ref, o_ref, h_ref = _lm_loop(tcfg, tmp_path / "a", 8, 4)
    fault = _fault_once(tmp_path / "b" / "fired", 5)
    with pytest.raises(Boom):
        _lm_loop(tcfg, tmp_path / "b", 8, 4, fault)
    p, o, h = _lm_loop(tcfg, tmp_path / "b", 8, 4, fault, seed=9)  # a different init, replaced
    ref = dict(p_ref.named_parameters())
    for name, t in p.named_parameters():
        assert torch.equal(t, ref[name]), name
        assert torch.equal(o.mu[name], o_ref.mu[name]) and torch.equal(o.nu[name], o_ref.nu[name])
    assert int(o.step) == int(o_ref.step) == 8
    assert [r["loss"] for r in h] == [r["loss"] for r in h_ref[4:]]


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """The reference's TrainLoop saves at step 10; the port restores that
    checkpoint, takes step 11 and matches the reference's step 11; the
    port's save at 11 restores with the reference's ``checkpoint.restore``."""
    jcfg, tcfg, jparams, _ = _models("qwen1.5-0.5b")
    lr = 3e-3
    jopt_cfg = JAdamWConfig(lr=lr)
    jts = jax.jit(jstep.make_train_step(
        jcfg, JPOLICY, jopt_cfg, lambda s: jschedule.warmup_cosine(s, warmup=2, total=12)))

    def jdata(start):
        return jtokens.batch_iterator(jcfg, 2, 16, start)

    a, b = tmp_path / "ref", tmp_path / "port"
    JTrainLoop(jts, jdata, a, JLoopConfig(total_steps=10, checkpoint_every=10)).run(
        jparams, jadamw.init(jparams, jopt_cfg))
    shutil.copytree(a, b)
    j11, jo11, _ = JTrainLoop(jts, jdata, a, JLoopConfig(total_steps=11, checkpoint_every=10)).run(
        jparams, jadamw.init(jparams, jopt_cfg))

    model = tmodel.init(torch.Generator().manual_seed(4), tcfg, TEST_POLICY, device="cpu")
    opt_cfg = AdamWConfig(lr=lr)
    ts = tstep.make_train_step(tcfg, TEST_POLICY, opt_cfg,
                               lambda s: warmup_cosine(s, warmup=2, total=12))
    loop = TrainLoop(ts, lambda s: ttokens.batch_iterator(tcfg, 2, 16, s, "cpu"), b,
                     LoopConfig(total_steps=11, checkpoint_every=10, log_every=1))
    model, opt, hist = loop.run(model, adamw.init(model, opt_cfg))
    assert [r["step"] for r in hist] == [10] and int(opt.step) == 11
    want = _by_name(j11, tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)

    step, trees = jckpt.restore(b, {"params": jparams, "opt_state": jadamw.init(jparams, jopt_cfg)})
    assert step == 11 and int(trees["opt_state"].step) == 11
    mine = convert.lm_train_state_to_numpy(model, opt, tcfg)
    for got, saved in ((mine["params"], trees["params"]), (mine["opt_state"].mu,
                                                           trees["opt_state"].mu)):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(saved)):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_train_state_roundtrips_through_the_reference_layout():
    jcfg, tcfg, jparams, tm = _models("qwen3-4b")
    tree = convert.lm_params_to_numpy(tm, tcfg)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in flat] == [k for k, _ in flat_ref]
    for (_, x), (_, y) in zip(flat, flat_ref):
        np.testing.assert_array_equal(x, y)
    st = adamw.init(tm, AdamWConfig())
    for t in st.mu.values():
        t.normal_(generator=torch.Generator().manual_seed(0))
    back = convert.adamw_state_from_numpy(convert.adamw_state_to_numpy(st, tcfg), tcfg,
                                          device="cpu")
    assert int(back.step) == 0 and back.step.dtype == torch.int32
    assert all(torch.equal(back.mu[n], st.mu[n]) for n in st.mu)
    ref_state = jax.tree.map(np.asarray, jadamw.init(jparams, JAdamWConfig()))
    from_ref = convert.adamw_state_from_numpy(ref_state, tcfg, device="cpu")
    assert set(from_ref.mu) == set(st.mu) and from_ref.mu["embed"].dtype == torch.float32


# ---------------------------------------------------- data and the launcher


def test_batch_iterator_resumes_at_any_step():
    jcfg, tcfg = jreduced(jget_arch("qwen1.5-0.5b")), reduced(get_arch("qwen1.5-0.5b"))
    it = ttokens.batch_iterator(tcfg, 3, 12, start_step=4, device="cpu")
    ref = jtokens.batch_iterator(jcfg, 3, 12, start_step=4)
    for _ in range(2):
        got, want = next(it), next(ref)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_train_main_on_cpu(tmp_path, capsys):
    hist = ttrain.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path),
                        "--ckpt-every", "2"])
    assert [r["step"] for r in hist] == [0, 1, 2, 3]
    out = capsys.readouterr().out
    assert "[train] qwen1.5-0.5b-smoke: step 0 loss" in out and "-> step 3 loss" in out
    assert (tmp_path / "step_00000004" / "params.npz").exists()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a mesh's many tiny ops; see tests/test_torch_mesh_lm.py
    try:
        for axis in ("--data-axis", "--model-axis"):  # a (2, 1) and a (1, 2) mesh
            mesh = ttrain.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--steps", "4",
                                "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path / axis),
                                "--ckpt-every", "2", axis, "2"])
            np.testing.assert_allclose([r["loss"] for r in mesh], [r["loss"] for r in hist],
                                       rtol=1e-5, err_msg=axis)
            assert (tmp_path / axis / "step_00000004" / "params.npz").exists()
    finally:
        torch.set_num_threads(threads)
