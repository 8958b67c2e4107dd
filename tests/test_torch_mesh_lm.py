"""The LM on a device mesh (``distributed.parallel``) against the JAX package
and against the port's own one-device path, on meshes of CPU shards
(``make_host_mesh``: every coordinate is ``cpu``, one process).

Bars: the reference's own (tests/test_distributed_subprocess.py): the mesh
loss within 2e-3 of the reference's one-device ``forward_train`` on the same
tree, the sequence-sharded decode within 2e-3 of its ``forward_decode``, the
elastic reshard exactly 0.0. Against the port's one-device run the bars are
tighter: the same f32 arithmetic but for the order of the cross-shard sums
(the loss within rtol 1e-6, each gradient within 1e-5 max|g|, the logits
within 1e-5), measured at a few ulps.
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
from repro_torch import convert, obs
from repro_torch.configs import get_arch, reduced
from repro_torch.data.tokens import synthetic_batch
from repro_torch.distributed import parallel
from repro_torch.launch import elastic, serve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, moe
from repro_torch.models import model as lm
from repro_torch.models.common import TEST_POLICY
from repro_torch.optim import adamw
from repro_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its tiny ops over many CPU shards
    run no slower on one, and under several test workers a team of threads
    each would crowd the machine's cores (measured: six copies of
    tests/test_torch_mesh_lm.py at once took 479 s on eight threads each,
    21 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reductions() -> int:
    return int(obs.counter("reduce.cross_device").value)


def _model(arch, **over):
    cfg = dataclasses.replace(reduced(get_arch(arch), **over), remat="none")
    return lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu"), cfg


def _batch(cfg, B, S):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in synthetic_batch(cfg, 0, B, S).items()}


def _grads(model, cfg, batch):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = lm.forward_train(model, cfg, TEST_POLICY, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    for p in named.values():
        p.requires_grad_(False)
    return float(loss.detach()), dict(zip(named, grads))


def _mesh_grads(p, batch):
    leaves = p.leaves()
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = parallel.forward_train(p, TEST_POLICY, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {n: sh.gather("cpu") for n, sh in
                         p.unflat(dict(zip(leaves, grads))).items()}


def test_mesh_loss_equals_the_reference_single_device():
    """Reduced qwen3-4b (GQA 4 / 1, qk-norm) on a (4, 2) mesh against the
    reference's one-device forward_train on the same tree and tokens."""
    jcfg, cfg = jreduced(jget_arch("qwen3-4b")), reduced(get_arch("qwen3-4b"))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.float32)
    want, _ = jmodel.forward_train(tree, jcfg, JPOLICY, {"tokens": jnp.asarray(toks),
                                                         "loss_mask": jnp.asarray(mask)})
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)}
    one, _ = lm.forward_train(model, cfg, TEST_POLICY, batch)
    p = parallel.shard_model(make_host_mesh(4, 2), model)
    before = _reductions()
    got, _ = parallel.forward_train(p, TEST_POLICY, batch)
    assert abs(float(got) - float(want)) < 2e-3
    assert abs(float(got) - float(one)) <= 1e-6 * abs(float(one))
    assert _reductions() > before


@pytest.mark.parametrize("arch,over,mesh", [
    ("qwen3-4b", {}, (4, 2)),
    ("qwen1.5-0.5b", {}, (2, 2)),  # qkv bias, tied head
    ("llava-next-34b", dict(padded_heads=8), (1, 2)),  # 7 of 8 heads real, masked per slice
    ("musicgen-large", {}, (2, 2)),  # four codebooks, gelu, sinusoidal positions
    # 6 / 3 heads on 2 shards: shard 0 reads KV heads 0, 0, 1 (not whole groups)
    ("qwen3-4b", dict(num_heads=6, num_kv_heads=3), (2, 2)),
])
def test_every_gradient_matches_one_device(arch, over, mesh):
    model, cfg = _model(arch, **over)
    if over.get("num_heads") == 6:
        assert attention.head_shards(cfg, 2)[0].kv_index == (0, 0, 1)
    batch = _batch(cfg, 4, 24)
    want_loss, want = _grads(model, cfg, batch)
    got_loss, got = _mesh_grads(parallel.shard_model(make_host_mesh(*mesh), model), batch)
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
    for n, g in want.items():
        assert float((got[n] - g).abs().max()) <= 1e-5 * float(g.abs().max()) + 1e-9, n


def test_adamw_step_under_remat_matches_one_device():
    """One ``make_train_step`` step on a (2, 2) mesh, remat on (the groups
    recomputed in the backward, their cross-device sums counted again),
    against one device: the loss, the clip's global norm over every block,
    and every parameter after the step within tests/test_torch_train.py's
    first-step bound, 1e-6 + lr min(2, delta eps / (|g| + eps)^2) for the
    clipped gradient g and its tolerance delta (1e-5 max|g|): the first Adam
    step g / (|g| + eps) magnifies a last-place gradient difference where
    |g| is near eps."""
    cfg = reduced(get_arch("qwen3-4b"))  # remat full
    model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=0.05)  # the clip binds
    p = parallel.shard_model(make_host_mesh(2, 2), model)
    opt_p = parallel.shard_opt_state(p, adamw.init(model, opt_cfg))
    opt = adamw.init(model, opt_cfg)
    step = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
    batch = _batch(cfg, 4, 16)
    _, g1 = _grads(model, cfg, batch)
    before = _reductions()
    _, opt_p, got = step(p, opt_p, batch)
    with_remat = _reductions() - before
    _, opt, want = step(model, opt, batch)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 * float(want["loss"])
    gnorm = float(want["grad_norm"])
    assert abs(float(got["grad_norm"]) - gnorm) <= 1e-5 * gnorm
    assert gnorm > 0.05 and int(opt_p.step) == 1
    eps, clip = opt_cfg.eps, opt_cfg.grad_clip / gnorm
    for n, x in model.named_parameters():
        g = g1[n] * clip
        bound = 1e-6 + opt_cfg.lr * torch.clamp(
            1e-5 * g.abs().max() * eps / (g.abs() + eps) ** 2, max=2.0)
        assert bool(((p.params[n].gather("cpu") - x.detach()).abs() <= bound).all()), n
    # each group's forward runs twice under remat: 2 x (2 layers x 2 sums x 2
    # data shards), plus the embedding's and the CE's sums
    assert with_remat >= 2 * cfg.num_layers * 2 * 2


def test_seq_sharded_decode_matches_the_reference():
    """The reference's check_seq_sharded_decode_matches: a random f32 cache of
    64 positions, batch 1, the token at cache_len 63, on an (8, 1) mesh (eight
    positions a shard, the last shard writes) against the reference's
    forward_decode; a (4, 2) mesh and an int8 cache against the port's own."""
    jcfg, cfg = jreduced(jget_arch("qwen3-4b")), reduced(get_arch("qwen3-4b"))
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
    for mesh, int8 in (((8, 1), False), ((4, 2), False), ((4, 2), True)):
        p = parallel.shard_model(make_host_mesh(*mesh), model)
        c = copy.deepcopy(cache)
        if int8:
            c = [{layer: attention.quantize_cache(st) for layer, st in g.items()}
                 for g in c]
            one, _ = lm.forward_decode(model, cfg, TEST_POLICY, step, copy.deepcopy(c), T - 1)
        mc = parallel.place_cache(p, c, seq_shard=True)
        assert mc.seq_sharded and mc.shards[0][0][0]["layer0"]["k"].shape[1] == T // mesh[0]
        got, mc = parallel.forward_decode(p, TEST_POLICY, step, mc, T - 1)
        assert float((got - one).abs().max()) < 1e-5, (mesh, int8)
        if not int8:
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-3, mesh


def test_moe_routing_is_the_same_on_every_shard(monkeypatch):
    """qwen2-moe on (2, 2), (B / D) S = 2 x 128 = 256 tokens a data shard, a
    whole number of routing groups: each data shard's ``ids``, ``pos`` and
    ``keep`` are its rows of the one-device routing, equal on both model
    shards, and the loss and aux loss equal one device's. (At 2 x 16 tokens a
    shard the groups differ from one device's, and so do the drops.)"""
    model, cfg = _model("qwen2-moe-a2.7b")
    batch = _batch(cfg, 4, 128)
    routes = []
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
    want, wm = lm.forward_train(model, cfg, TEST_POLICY, batch)
    one = list(routes)
    routes.clear()
    got, gm = parallel.forward_train(parallel.shard_model(make_host_mesh(2, 2), model),
                                     TEST_POLICY, batch)
    assert len(one) == cfg.num_layers and len(routes) == 4 * cfg.num_layers
    for layer, r in enumerate(one):
        shards = routes[4 * layer:4 * (layer + 1)]  # (0, 0), (0, 1), (1, 0), (1, 1)
        for f in ("ids", "pos", "keep"):
            for s in shards:
                assert s.capacity == r.capacity
            assert torch.equal(getattr(shards[0], f), getattr(shards[1], f)), f
            assert torch.equal(getattr(shards[2], f), getattr(shards[3], f)), f
            assert torch.equal(torch.cat([getattr(shards[0], f), getattr(shards[2], f)]),
                               getattr(r, f)), f
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    assert abs(float(gm["aux"]) - float(wm["aux"])) <= 1e-6 * float(wm["aux"])


def test_ssm_archs_raise_at_model_2_and_run_data_parallel(monkeypatch):
    """The SSM archs at model axis 2, where they once raised, now run there:
    reduced jamba (Mamba, attention and MoE layers) and rwkv6 (48 -> 6
    heads, 4 real, so model shard 1 holds a real head and two padded ones)
    shard at (1, 2), and their loss and every gradient match one device at
    the attention archs' bars; the data-parallel (2, 1) mesh still matches,
    and so does greedy ``generate``. The MoE routes groups of 16 tokens, a
    whole number of them in each data shard."""
    monkeypatch.setattr(moe, "GROUP_SIZE", 16)
    for arch, over in (("jamba-1.5-large-398b", {}), ("rwkv6-3b", dict(padded_heads=6))):
        model, cfg = _model(arch, **over)
        batch = _batch(cfg, 4, 16)
        want_loss, want = _grads(model, cfg, batch)
        got_loss, got = _mesh_grads(parallel.shard_model(make_host_mesh(1, 2), model), batch)
        assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss), arch
        for n, g in want.items():
            assert float((got[n] - g).abs().max()) <= 1e-5 * float(g.abs().max()) + 1e-9, n
    want, _ = lm.forward_train(model, cfg, TEST_POLICY, batch)
    p = parallel.shard_model(make_host_mesh(2, 1), model)
    got, _ = parallel.forward_train(p, TEST_POLICY, batch)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    prompt = {"tokens": batch["tokens"]}
    one = serve.generate(model, cfg, TEST_POLICY, prompt, 3)
    mesh = serve.generate(p, cfg, TEST_POLICY, prompt, 3)
    assert torch.equal(mesh.tokens, one.tokens)
    np.testing.assert_allclose(mesh.logits.numpy(), one.logits.numpy(), atol=1e-5)


@pytest.mark.parametrize("batch,mesh,int8", [(4, (2, 2), False), (1, (2, 2), True),
                                             (2, (1, 2), True)])
def test_generate_on_a_mesh_matches_one_device(batch, mesh, int8):
    """Prefill and greedy decode through ``serve.generate``: batch-sharded,
    and a batch of 1 on two data shards (the replicated prefill, then the
    cache cut over its positions), bf16 and int8 caches."""
    model, cfg = _model("qwen3-4b")
    toks = torch.randint(0, cfg.vocab_size, (batch, 10), generator=torch.Generator().manual_seed(2))
    one = serve.generate(model, cfg, TEST_POLICY, {"tokens": toks}, 6, kv_int8=int8)
    p = parallel.shard_model(make_host_mesh(*mesh), model)
    got = serve.generate(p, cfg, TEST_POLICY, {"tokens": toks}, 6, kv_int8=int8)
    assert torch.equal(got.tokens, one.tokens)
    np.testing.assert_allclose(got.logits.numpy(), one.logits.numpy(), atol=1e-5)


@pytest.mark.parametrize("batch,mesh", [(2, (1, 2)), (1, (2, 2))])
def test_generate_where_a_shard_reads_several_kv_heads(batch, mesh, monkeypatch):
    """8 query / 4 KV heads on two model shards: each shard's 4 query heads
    read 2 KV heads, which decode repeats to one a query head; batch-sharded
    and sequence-sharded. A shard projects only its KV heads, so its f32 k, v
    differ from one device's in the last place (another GEMM width), which a
    bf16 cache can round one bf16 ulp apart (2e-5 in the logits): the
    prefill's cache stays f32 here, where the bar holds at 1.5e-7."""
    prefill = attention.fwd_prefill

    def f32_prefill(p, cfg, policy, h, positions, heads=None):
        _, k, v = attention._project_qkv(p, cfg, policy, h, positions)
        return prefill(p, cfg, policy, h, positions, heads)[0], {"k": k, "v": v}

    monkeypatch.setattr(attention, "fwd_prefill", f32_prefill)
    model, cfg = _model("qwen3-4b", num_heads=8, num_kv_heads=4)
    assert attention.head_shards(cfg, 2)[1] == attention.Heads(4, 8, 2, 4, None)
    toks = torch.randint(0, cfg.vocab_size, (batch, 10), generator=torch.Generator().manual_seed(2))
    one = serve.generate(model, cfg, TEST_POLICY, {"tokens": toks}, 6)
    p = parallel.shard_model(make_host_mesh(*mesh), model)
    got = serve.generate(p, cfg, TEST_POLICY, {"tokens": toks}, 6)
    assert torch.equal(got.tokens, one.tokens)
    np.testing.assert_allclose(got.logits.numpy(), one.logits.numpy(), atol=1e-5)


def test_train_and_serve_main_on_a_2x2_mesh(tmp_path, capsys):
    """The launchers with ``--data-axis 2 --model-axis 2 --device cpu``: the
    loss falls and each step's equals the (1, 1) run's; serve runs."""
    common = ["--device", "cpu", "--arch", "qwen1.5-0.5b", "--steps", "5", "--batch", "4",
              "--seq", "16", "--ckpt-every", "5"]
    one = ttrain.main(common + ["--ckpt", str(tmp_path / "one")])
    mesh = ttrain.main(common + ["--ckpt", str(tmp_path / "mesh"), "--data-axis", "2",
                                 "--model-axis", "2"])
    losses = [r["loss"] for r in mesh]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, [r["loss"] for r in one], rtol=1e-5)
    assert "on a 2 x 2 mesh" in capsys.readouterr().out
    resumed = ttrain.main(common[:5] + ["7"] + common[6:] + [
        "--ckpt", str(tmp_path / "mesh"), "--data-axis", "2", "--model-axis", "2"])
    assert [r["step"] for r in resumed] == [5, 6]  # the mesh's state, restored in place
    toks = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                       "--data-axis", "2", "--model-axis", "2"])
    assert toks.shape == (2, 3)
    assert "on a 2 x 2 mesh of cpu" in capsys.readouterr().out


def test_elastic_reshard_from_4x2_to_2x2(tmp_path):
    """A run trained and saved on (4, 2) (``TrainLoop``'s gathered trees)
    restored onto (2, 2) by ``reshard_restore``: every parameter and moment
    exactly equal (max diff 0.0), the step as saved; training resumes."""
    from repro_torch.train.loop import LoopConfig, TrainLoop

    model, cfg = _model("qwen1.5-0.5b")
    opt_cfg = adamw.AdamWConfig(lr=1e-2)
    p = parallel.shard_model(make_host_mesh(4, 2), model)
    opt = parallel.shard_opt_state(p, adamw.init(model, opt_cfg))
    step = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)

    def data(start):
        while True:
            yield _batch(cfg, 4, 16)

    loop = TrainLoop(step, data, tmp_path, LoopConfig(total_steps=2, checkpoint_every=1))
    p, opt, _ = loop.run(p, opt)
    s, q, qopt = elastic.reshard_restore(tmp_path, cfg, TEST_POLICY, opt_cfg,
                                         make_host_mesh(2, 2))
    assert s == 2 and int(qopt.step) == 2 and q.grid.D == 2
    diff = max(float((b[n].gather("cpu") - sh.gather("cpu")).abs().max())
               for a, b in ((p.params, q.params), (opt.mu, qopt.mu), (opt.nu, qopt.nu))
               for n, sh in a.items())
    assert diff == 0.0
    _, _, m = step(q, qopt, _batch(cfg, 4, 16))
    assert np.isfinite(float(m["loss"]))


def test_a_mesh_of_more_cards_than_visible_raises():
    """Without ``--device`` the launchers' mesh is over the visible cards,
    and asking for more than there are raises: no quiet run on the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four cards are visible")
    for main in (ttrain.main, serve.main):
        args = ["--data-axis", "2", "--model-axis", "2"]
        with pytest.raises(RuntimeError, match="CUDA cards"):
            main(args + (["--arch", "qwen1.5-0.5b"] if main is ttrain.main else []))
