"""The dry-run (``launch.dryrun``) on the CPU, with no devices: each cell's
sharded step run on ``meta`` devices and counted.

  * The per-device parameter, optimizer-state and decode-cache bytes of
    every arch at full width, on (16, 16) and (2, 16, 16), equal the
    reference's: ``jax.eval_shape`` of its ``init`` / ``init_cache`` placed
    by its ``param_pspecs`` / ``opt_state_pspecs`` / ``cache_pspecs`` over
    a ``jax.sharding.AbstractMesh``.
  * On reduced archs on a (2, 2) ``meta`` mesh, the counted flops equal a
    ``FlopCounterMode`` count of the same step on CPU shards, op by op. The
    CPU shards reach the attention through the card's route (the counted op
    forward, ``attention_backward``'s recompute backward), so that both
    count the kernel's work and not the plain S x S softmax.
  * Records load through the port's ``roofline.analysis``; ``skipped`` and
    ``fail`` records, the exit code and ``--opt`` behave as the reference's.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as jshd
from repro.models import model as jmodel
from repro.models.common import Policy as JPolicy
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.data.tokens import synthetic_batch
from repro_torch.distributed import checkpoint, parallel
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, moe, rwkv6
from repro_torch.models import model as lm
from repro_torch.models.common import TEST_POLICY, Policy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import analysis


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a reference tree of ShapeDtypeStructs placed by
    its PartitionSpecs (GSPMD pads an uneven split: rounded up)."""
    total = 0
    for x, s in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(specs, is_leaf=lambda z: isinstance(z, JP))):
        n = 1
        for d, size in enumerate(x.shape):
            e = s[d] if d < len(s) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            n *= -(-size // math.prod(mesh.shape[a] for a in axes))
        total += n * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_placement_bytes_equal_the_references(arch):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jpol = JPolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    params = jax.eval_shape(lambda k: jmodel.init(k, jcfg, jpol), jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda: jadamw.init(
        params, jadamw.AdamWConfig(moments_dtype=jcfg.moments_dtype)))
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
    for multi_pod in (False, True):
        jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
                 else AbstractMesh((16, 16), ("data", "model")))
        mesh = dryrun.mesh_of(multi_pod)
        want_p = _ref_bytes(params, jshd.param_pspecs(jcfg, params), jmesh)
        want_o = _ref_bytes(opt, jshd.opt_state_pspecs(jcfg, params, opt), jmesh)
        for shape in ("decode_32k", "long_500k"):
            if shape not in cfg.runnable_shapes():
                continue
            s = dryrun.SHAPES[shape]
            cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, s.batch, s.seq_len,
                                                             jnp.bfloat16))
            want_c = _ref_bytes(cache, jshd.cache_pspecs(jcfg, shape, jmesh, cache), jmesh)
            got = dryrun.placement_bytes(cfg, shape, mesh, dryrun.POLICY, opt_cfg)
            assert got["param_bytes"] == want_p, (multi_pod, shape)
            assert got["opt_state_bytes"] == want_o, (multi_pod, shape)
            assert got["cache_bytes"] == want_c, (multi_pod, shape)


def _cpu_route(monkeypatch):
    """CPU tensors through the card's attention route: the counted op in
    place of the launch, ``FlashAttention`` under grad."""
    def bhsd(q, k, v, *, window=0):
        return torch.ops.repro_torch.flash_attention(q, k, v, window)

    def routed(q, k, v, *, window=0):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _flash.FlashAttention.apply(q, k, v, window)
        return bhsd(q, k, v, window=window)

    monkeypatch.setattr(_flash, "flash_attention_bhsd", bhsd)
    monkeypatch.setattr(ops, "flash_attention", routed)


CASES = [("qwen3-4b", {}), ("jamba-1.5-large-398b", {}), ("rwkv6-3b", dict(padded_heads=6))]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,over", CASES, ids=[a for a, _ in CASES])
def test_meta_flops_equal_a_flop_count_on_cpu_shards(arch, over, kind, monkeypatch):
    """The same step, from the same layout, on a (2, 2) mesh of ``meta``
    devices under the dry-run's count and of CPU shards under
    ``FlopCounterMode``: every op's flops equal (the SSM scans counted once
    a token on ``meta``, run token by token on the CPU)."""
    _cpu_route(monkeypatch)
    monkeypatch.setattr(moe, "GROUP_SIZE", 16)
    cfg = reduced(get_arch(arch), **over)
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
    B, S = 4, 16
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in synthetic_batch(cfg, 0, B, S).items()}
    if kind != "train":
        batch = {"tokens": batch["tokens"][:, :1] if kind == "decode" else batch["tokens"]}
    counts = {}
    for device in ("meta", "cpu"):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[device] * 4)
        model = (lm.build(cfg, TEST_POLICY, device="meta") if device == "meta" else
                 lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu"))
        p = parallel.shard_model(mesh, model)
        step = dryrun.prepare_step(cfg, TEST_POLICY, opt_cfg, p, kind,
                                   {k: v.to(device) for k, v in batch.items()}, cache=(B, S))
        if device == "meta":
            counts[device] = dryrun.count(step)["flops_by_op"]
        else:
            with FlopCounterMode(display=False) as fc:
                step()
            counts[device] = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts["meta"] == counts["cpu"]
    assert sum(counts["meta"].values()) > 0
    if arch != "rwkv6-3b" and kind != "decode":
        assert counts["meta"]["repro_torch.flash_attention"] > 0


def test_records_load_through_the_roofline_analysis(tmp_path):
    """Reduced archs' cells on a (2, 2) ``meta`` mesh: the record's fields,
    per device, and ``load_results`` / ``analyze_record`` over them."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    out = tmp_path / "r.jsonl"
    cfgs = {}
    for arch, over in CASES:
        cfg = reduced(get_arch(arch), **over)
        cfgs[arch] = cfg
        for shape in ("train_4k", "decode_32k"):
            rec = dryrun.run_cell(arch, shape, False, cfg=cfg, mesh=mesh)
            assert rec["status"] == "ok" and rec["mesh"] == {"data": 2, "model": 2}
            for key in ("flops", "gemm_flops", "bytes", "hbm_bytes", "collective_bytes",
                        "collective_count", "param_bytes", "opt_state_bytes", "batch_bytes",
                        "wall_s"):
                assert rec[key] > 0, (arch, shape, key)
            assert rec["hbm_bytes"] < rec["bytes"] and rec["gemm_flops"] <= rec["flops"]
            assert (rec["cache_bytes"] > 0) == (shape == "decode_32k")
            assert "compile_s" in rec["no_counterpart"]
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
    recs = analysis.load_results(out)
    assert len(recs) == 6
    for rec in recs:
        a = analysis.analyze_record(rec, cfgs[rec["arch"]])
        assert a["t_compute_s"] > 0 and a["t_memory_s"] > 0 and a["useful_ratio"] > 0


def test_fsdp_gathers_are_counted_and_no_fsdp_drops_them():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    cfg = reduced(get_arch("qwen3-4b"))
    fsdp = dryrun.run_cell("qwen3-4b", "prefill_32k", False, cfg=cfg, mesh=mesh)
    plain = dryrun.run_cell("qwen3-4b", "prefill_32k", False, cfg=cfg, mesh=mesh,
                            opts=("no_fsdp",))
    assert fsdp["bytes_all-gather"] > plain.get("bytes_all-gather", 0)
    assert fsdp["param_bytes"] < plain["param_bytes"]
    assert fsdp["bytes_all-reduce"] == plain["bytes_all-reduce"] > 0
    assert fsdp["flops"] == plain["flops"]


def test_skipped_and_failed_cells_and_the_exit_code(tmp_path, monkeypatch, capsys):
    """A full-attention arch's long_500k is recorded ``skipped`` (exit 0); a
    cell that raises is recorded ``fail`` with its error, the sweep goes on,
    and the exit code is 1."""
    out = tmp_path / "r.jsonl"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--out",
                        str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k", "--both-meshes",
                        "--jobs", "2", "--out", str(out)]) == 0  # in worker processes
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["arch"], r["multi_pod"], r["status"]) for r in recs[1:]] == [
        ("llama3-8b", False, "skipped"), ("llama3-8b", True, "skipped")]
    out.unlink()
    assert "long_500k" in get_arch("rwkv6-3b").runnable_shapes()
    assert "long_500k" in get_arch("jamba-1.5-large-398b").runnable_shapes()

    def boom(arch, shape, multi_pod, *, opts=()):
        if multi_pod:
            raise RuntimeError("no luck")
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "skipped",
                "reason": "stub"}

    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--both-meshes",
                        "--out", str(out)]) == 1
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["skipped", "fail"]
    assert recs[-1]["error"] == "RuntimeError: no luck" and recs[-1]["multi_pod"]
    assert "done: 0 ok, 1 failed" in capsys.readouterr().out


def test_options_apply_and_are_restored():
    cfg = get_arch("qwen1.5-0.5b")
    before = (rwkv6.WKV_CHUNK, moe.CAPACITY_FACTOR, moe.GROUP_SIZE, lm.LOSS_CHUNK,
              attention.CAUSAL_SKIP)
    opts = ["no_fsdp", "no_remat", "accum=4", "kv_int8", "causal_skip", "wkv_chunk=16",
            "moe_cf=2.0", "moe_group=64", "loss_chunk=128"]
    with dryrun.options(cfg, opts) as (c, knobs):
        assert not c.zero_shard_params and c.remat == "none"
        assert knobs.accum == 4 and knobs.cache_dtype == torch.int8
        assert (rwkv6.WKV_CHUNK, moe.CAPACITY_FACTOR, moe.GROUP_SIZE, lm.LOSS_CHUNK,
                attention.CAUSAL_SKIP) == (16, 2.0, 64, 128, True)
    assert (rwkv6.WKV_CHUNK, moe.CAPACITY_FACTOR, moe.GROUP_SIZE, lm.LOSS_CHUNK,
            attention.CAUSAL_SKIP) == before
    with pytest.raises(RuntimeError):
        with dryrun.options(cfg, ["moe_group=8"]):
            raise RuntimeError("a cell failed")
    assert moe.GROUP_SIZE == before[2]
    with dryrun.options(cfg, ["fsdp"]) as (c, _):
        assert c.zero_shard_params


@pytest.mark.parametrize("opt", ["qchunk=128", "kvchunk=256", "no_such_opt"])
def test_unported_and_unknown_options_raise(opt, tmp_path):
    with pytest.raises(ValueError, match="no counterpart" if "chunk" in opt else "unknown"):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--opt", opt,
                     "--out", str(tmp_path / "r.jsonl")])
    assert not (tmp_path / "r.jsonl").exists()


def test_dump_hlo_has_no_counterpart(tmp_path):
    with pytest.raises(NotImplementedError, match="no counterpart"):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--dump-hlo", str(tmp_path)])


def test_options_reach_the_counted_step():
    """``causal_skip`` replaces the attention op by the triangle's tiles on
    ``meta`` (their products counted as bmm, once a tile), ``wkv_chunk=``
    runs rwkv6's chunked form, ``accum=`` splits the batch, ``kv_int8`` gives
    an int8 cache; no option is left set after its cell."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    cfg = reduced(get_arch("qwen3-4b"))
    base = dryrun.run_cell("qwen3-4b", "prefill_32k", False, cfg=cfg, mesh=mesh)
    skip = dryrun.run_cell("qwen3-4b", "prefill_32k", False, cfg=cfg, mesh=mesh,
                           opts=("causal_skip",))
    assert "repro_torch.flash_attention" not in skip["flops_by_op"]
    attn = base["flops_by_op"]["repro_torch.flash_attention"]
    extra = skip["flops_by_op"]["aten.bmm"] - base["flops_by_op"].get("aten.bmm", 0)
    # whole 256-row tiles on and under the diagonal: (n + 1) / n of the triangle
    n = 32_768 // attention.CAUSAL_SKIP_CHUNK
    assert extra == pytest.approx(attn * (n + 1) / n, rel=1e-3)
    assert attention.CAUSAL_SKIP is False
    rcfg = reduced(get_arch("rwkv6-3b"), padded_heads=6)
    scan = dryrun.run_cell("rwkv6-3b", "train_4k", False, cfg=rcfg, mesh=mesh)
    chunk = dryrun.run_cell("rwkv6-3b", "train_4k", False, cfg=rcfg, mesh=mesh,
                            opts=("wkv_chunk=16",))
    assert chunk["flops"] != scan["flops"] and rwkv6.WKV_CHUNK == 0
    accum = dryrun.run_cell("qwen3-4b", "train_4k", False, cfg=cfg, mesh=mesh,
                            opts=("accum=2",))
    one = dryrun.run_cell("qwen3-4b", "train_4k", False, cfg=cfg, mesh=mesh)
    assert accum["gemm_flops"] == pytest.approx(one["gemm_flops"], rel=1e-6)
    int8 = dryrun.run_cell("qwen3-4b", "decode_32k", False, cfg=cfg, mesh=mesh,
                           opts=("kv_int8",))
    bf16 = dryrun.run_cell("qwen3-4b", "decode_32k", False, cfg=cfg, mesh=mesh)
    assert int8["cache_bytes"] < bf16["cache_bytes"]


def test_causal_skip_off_the_card_equals_the_plain_attention(monkeypatch):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 16), generator=g)
    k, v = (torch.randn((2, 64, 2, 16), generator=g) for _ in range(2))
    monkeypatch.setattr(attention, "CAUSAL_SKIP_CHUNK", 16)
    for window in (0, 24):
        want = attention._flash_attention(q, k, v, window)
        monkeypatch.setattr(attention, "CAUSAL_SKIP", True)
        got = attention._flash_attention(q, k, v, window)
        monkeypatch.setattr(attention, "CAUSAL_SKIP", False)
        assert float((got - want).abs().max()) < 1e-5, window


def test_meta_never_becomes_a_number():
    """A counted step allocates nothing and reads no value: its outputs stay
    on ``meta``, and one that reaches numpy or ``float`` raises."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    cfg = reduced(get_arch("jamba-1.5-large-398b"))
    p = parallel.shard_model(mesh, lm.build(cfg, Policy(), device="meta"))
    batch = {k: v for k, v in cfg.input_specs("train_4k", torch.float32).items()}
    step = dryrun.prepare_step(cfg, Policy(), AdamWConfig(), p, "train", batch)
    _, state, metrics = step()
    assert metrics["loss"].is_meta and metrics["grad_norm"].is_meta
    assert all(b.is_meta for sh in state.mu.values() for b in sh.blocks.values())
    with pytest.raises((NotImplementedError, RuntimeError)):
        float(metrics["loss"])
    with pytest.raises((NotImplementedError, RuntimeError)):
        checkpoint.host_array(metrics["loss"])
