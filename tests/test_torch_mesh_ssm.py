"""Mamba and RWKV6 layers under a model axis (``distributed.parallel``) on
meshes of CPU shards, against the port's one-device path and the JAX
package's.

Reduced jamba (Mamba layers, one attention layer and MoE FFNs a group) and
reduced rwkv6 with 6 physical heads of which 4 are real (so a model shard
holds padded heads) train on (1, 2), (2, 2) and the three-axis (2, 2, 2)
``("pod", "data", "model")`` mesh at the bars the attention archs are held
to in tests/test_torch_mesh_lm.py: the loss within rtol 1e-6 and every
gradient within 1e-5 max|g| of one device. The mid-layer sum of a Mamba
shard's ``x_proj`` output keeps inside them. The MoE routes groups of 16
tokens here, so that every data shard holds whole groups and routes as one
device does. The sequence-sharded decode of jamba is held to the
reference's 2e-3.
"""
import copy
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
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data.tokens import synthetic_batch
from repro_torch.distributed import parallel
from repro_torch.launch import elastic, serve
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import moe
from repro_torch.models import model as lm
from repro_torch.models.common import TEST_POLICY
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ARCHS = {"jamba": ("jamba-1.5-large-398b", {}), "rwkv6": ("rwkv6-3b", dict(padded_heads=6))}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """One intra-op thread (tiny ops over many CPU shards), and MoE routing
    groups of 16 tokens."""
    monkeypatch.setattr(moe, "GROUP_SIZE", 16)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _model(name, remat="none"):
    arch, over = ARCHS[name]
    cfg = dataclasses.replace(reduced(get_arch(arch), **over), remat=remat)
    return lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu"), cfg


def _batch(cfg, B, S):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in synthetic_batch(cfg, 0, B, S).items()}


def _grads(loss_fn, leaves):
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = loss_fn()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("name", ["jamba", "rwkv6"])
def test_every_gradient_matches_one_device(name, shape):
    model, cfg = _model(name)
    batch = _batch(cfg, 4, 16)
    want_loss, want = _grads(lambda: lm.forward_train(model, cfg, TEST_POLICY, batch),
                             dict(model.named_parameters()))
    p = parallel.shard_model(_mesh(shape), model)
    got_loss, flat = _grads(lambda: parallel.forward_train(p, TEST_POLICY, batch), p.leaves())
    got = {n: sh.gather("cpu") for n, sh in p.unflat(flat).items()}
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
    for n, g in want.items():
        assert float((got[n] - g).abs().max()) <= 1e-5 * float(g.abs().max()) + 1e-9, n


def test_a_train_step_on_a_pod_data_model_mesh_equals_one_device():
    """``make_train_step`` on a (2, 2, 2) mesh (data shards row-major over
    pod and data, FSDP over ``data``) against one device, remat on: the
    loss, the clip's global norm, and every parameter after the AdamW step
    (the bound of tests/test_torch_mesh_lm.py's remat step)."""
    for name, arch in (("qwen3-4b", "qwen3-4b"), ("jamba", None)):
        if arch:
            cfg = reduced(get_arch(arch))
            model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu")
        else:
            model, cfg = _model(name, remat="full")
        opt_cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=0.05)
        p = parallel.shard_model(_mesh((2, 2, 2)), model)
        opt_p = parallel.shard_opt_state(p, adamw.init(model, opt_cfg))
        opt = adamw.init(model, opt_cfg)
        step = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
        batch = _batch(cfg, 4, 16)
        _, g1 = _grads(lambda: lm.forward_train(model, cfg, TEST_POLICY, batch),
                       dict(model.named_parameters()))
        _, opt_p, got = step(p, opt_p, batch)
        _, opt, want = step(model, opt, batch)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 * float(want["loss"])
        gnorm = float(want["grad_norm"])
        assert abs(float(got["grad_norm"]) - gnorm) <= 1e-5 * gnorm, name
        eps, clip = opt_cfg.eps, opt_cfg.grad_clip / gnorm
        for n, x in model.named_parameters():
            g = g1[n] * clip
            bound = 1e-6 + opt_cfg.lr * torch.clamp(
                1e-5 * g.abs().max() * eps / (g.abs() + eps) ** 2, max=2.0)
            assert bool(((p.params[n].gather("cpu") - x.detach()).abs() <= bound).all()), n


@pytest.mark.parametrize("name", ["jamba", "rwkv6"])
def test_generate_at_model_2_matches_one_device(name):
    """Prefill and greedy decode at (1, 2): each shard's Mamba h and conv
    window, or its heads of the RWKV6 state S, stepped on its own."""
    model, cfg = _model(name)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    one = serve.generate(model, cfg, TEST_POLICY, {"tokens": toks}, 6)
    p = parallel.shard_model(make_host_mesh(1, 2), model)
    got = serve.generate(p, cfg, TEST_POLICY, {"tokens": toks}, 6)
    assert torch.equal(got.tokens, one.tokens)
    np.testing.assert_allclose(got.logits.numpy(), one.logits.numpy(), atol=1e-5)


def test_seq_sharded_decode_of_jamba_matches_the_reference():
    """The reference's long_500k layout on an arch with attention and Mamba
    layers: a random f32 cache of 64 positions, batch 1, the token at
    cache_len 63, on a (2, 1) mesh (the attention's k, v over the data
    shards, the Mamba states replicated) against the reference's
    forward_decode within its 2e-3, and the port's own within 1e-5; on
    (2, 2) too, the states also split over d_inner."""
    jcfg = jreduced(jget_arch("jamba-1.5-large-398b"))
    cfg = reduced(get_arch("jamba-1.5-large-398b"))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY))
    T = 64
    rng = np.random.default_rng(5)
    jcache = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
                          jmodel.init_cache(jcfg, 1, T, dtype=jnp.float32))
    want, _ = jmodel.forward_decode(tree, jcfg, JPOLICY, {"tokens": jnp.array([[17]], jnp.int32)},
                                    jax.tree.map(jnp.asarray, jcache), jnp.int32(T - 1))
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    cache = [{layer: {n: torch.from_numpy(np.array(a[g])) for n, a in st.items()}
              for layer, st in jcache.items()} for g in range(cfg.num_groups)]
    step = {"tokens": torch.tensor([[17]])}
    one, _ = lm.forward_decode(model, cfg, TEST_POLICY, step, copy.deepcopy(cache), T - 1)
    for shape in ((2, 1), (2, 2)):
        p = parallel.shard_model(make_host_mesh(*shape), model)
        mc = parallel.place_cache(p, copy.deepcopy(cache), seq_shard=True)
        assert mc.shards[1][0][0]["layer4"]["k"].shape[1] == T // 2
        assert mc.shards[1][0][0]["layer0"]["h"].shape[1] == cfg.ssm_d_inner // shape[1]
        got, _ = parallel.forward_decode(p, TEST_POLICY, step, mc, T - 1)
        assert float((got - one).abs().max()) < 1e-5, shape
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-3, shape


def test_elastic_reshard_of_an_ssm_train_state(tmp_path):
    """Reduced jamba, bf16 moments as its config sets them, trained and
    saved on (2, 2) by ``TrainLoop`` and restored onto (1, 2) by
    ``reshard_restore``: every Mamba, attention and MoE parameter and moment
    bit for bit, the step as saved; training resumes there."""
    from repro_torch.train.loop import LoopConfig, TrainLoop

    model, cfg = _model("jamba")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, moments_dtype=cfg.moments_dtype)
    p = parallel.shard_model(make_host_mesh(2, 2), model)
    opt = parallel.shard_opt_state(p, adamw.init(model, opt_cfg))
    step = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)

    def data(start):
        while True:
            yield _batch(cfg, 4, 16)

    loop = TrainLoop(step, data, tmp_path, LoopConfig(total_steps=2, checkpoint_every=1))
    p, opt, _ = loop.run(p, opt)
    s, q, qopt = elastic.reshard_restore(tmp_path, cfg, TEST_POLICY, opt_cfg,
                                         make_host_mesh(1, 2))
    assert s == 2 and int(qopt.step) == 2 and q.grid.M == 2
    assert qopt.mu["groups.0.layer0.mixer.A_log"].dtype == torch.bfloat16
    for a, b in ((p.params, q.params), (opt.mu, qopt.mu), (opt.nu, qopt.nu)):
        for n, sh in a.items():
            assert torch.equal(b[n].gather("cpu"), sh.gather("cpu")), n
    _, _, m = step(q, qopt, _batch(cfg, 4, 16))
    assert np.isfinite(float(m["loss"]))
