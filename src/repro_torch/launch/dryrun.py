"""The dry-run: every (arch x shape x mesh) cell's sharded step, run on
``meta`` devices, counted, one JSONL record a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --shape ... --opt no_fsdp

It needs no card: it runs on the host, allocates no tensor memory, and
writes to ``benchmarks/torch_dryrun_results.jsonl`` unless ``--out`` says
otherwise (records are appended; a reader keeps the last per cell).

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each cell
ahead of time for 256 or 512 forced host devices and reads XLA's cost and
memory analyses. The port has no compiler to ask. It runs the sharded steps
themselves, ``distributed.parallel``'s train, prefill and decode steps and
``train.step``'s AdamW step, on a mesh of ``meta`` devices:
``launch.mesh.make_mesh((16, 16), ("data", "model"), devices=["meta"] *
256)``, or (2, 16, 16) with ``"pod"`` over 512. The parameters come from
``models.model.build(cfg, policy, device="meta")``, placed by the sharding
rules, the inputs from ``ArchConfig.input_specs``; the policy is the
reference's, bf16 parameters and bf16 compute. A decode cell reads a cache
of the shape's full length at ``cache_len = seq_len - 1``. Every
coordinate's work runs, so a cell's wall time grows with the mesh.

What a record counts (``Count``, a dispatch mode over every ``meta`` op the
step runs, its forward, its backward and the recompute of remat alike):

  * ``flops``: the ops ``torch.utils.flop_counter`` has a formula for (the
    matrix products, the convolution, and the flash attention's op,
    ``kernels.flash_attention.causal_pairs``), the count ``FlopCounterMode``
    gives; ``gemm_flops`` is the part in ``aten.mm``, ``bmm`` and
    ``addmm``. Elementwise work is not counted, as that counter does not.
  * ``bytes``: each op's tensor inputs read once and its outputs written
    once, views excepted (XLA's per-instruction "bytes accessed").
  * ``hbm_bytes``: the same over the ops whose operands must cross device
    memory even when elementwise chains fuse into their neighbours: the
    counted-flop ops, reductions, gathers, scatters, sorts, concatenations
    and the copies into caches (the reference's fusion-optimistic rule).
  * ``transcendentals``: the elements of exp, log, tanh, sigmoid, ... outputs.
  * A per-token loop of the SSM layers (and the causal-skip tile loop) runs
    one step on ``meta`` and counts it once a token (``common.repeated``),
    as the reference's cost scales a while body by its trip count.
  * ``collective_bytes``: a ``cross_device_sum`` of n shards of s bytes is
    a ring all-reduce, 2 (n - 1) / n s bytes on each of its n devices; the
    FSDP gathers are the bytes ``Sharded.take`` reads from blocks its
    coordinate does not hold (``launch.mesh.watch_transfers``).
    ``collective_count`` counts each device's part in one.

Every count is the whole mesh's divided by its coordinates (per device; the
mesh is symmetric). The per-device ``param_bytes``, ``opt_state_bytes``,
``cache_bytes`` and ``batch_bytes`` come from the specs as GSPMD places
them: each leaf's block at its spec, a replicated leaf on every device (the
port stores a block once, on its first coordinate, but that does not set
them). ``wall_s`` is the cell's wall time, where the reference has
``lower_s`` and ``compile_s``. What only a compiler gives is listed under
``no_counterpart``. ``--opt`` takes the reference's options and restores
every module global an option sets after its cell; ``qchunk=``,
``kvchunk=`` and ``--dump-hlo`` have no counterpart and raise.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, get_arch, list_archs
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh, watch_transfers
from repro_torch.models import attention, moe, rwkv6
from repro_torch.models import model as lm
from repro_torch.models.common import Policy, trip_factor
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import step as step_lib

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks" / "torch_dryrun_results.jsonl"

#: The reference's record fields that only XLA's compiler gives (its
#: ``bytes_all-gather`` and ``bytes_all-reduce`` are the port's two kinds of
#: transfer here, and its ``transcendentals`` counts outputs of the ops above).
NO_COUNTERPART = (
    "xla_flops_once", "xla_bytes_once", "argument_size_in_bytes", "output_size_in_bytes",
    "temp_size_in_bytes", "generated_code_size_in_bytes", "alias_size_in_bytes",
    "bytes_reduce-scatter", "bytes_all-to-all", "bytes_collective-permute", "lower_s",
    "compile_s", "analyze_s",
)

_GEMMS = {"aten.mm", "aten.bmm", "aten.addmm"}
_MOVES = {"aten.embedding", "aten.index_select", "aten.gather", "aten.scatter",
          "aten.scatter_add", "aten.index", "aten.index_put", "aten.index_add", "aten.cat",
          "aten.sort", "aten.topk", "aten.cumsum", "aten.copy", "aten.sum", "aten.mean",
          "aten.amax", "aten.amin", "aten.max", "aten.min", "aten.logsumexp", "aten._softmax",
          "aten._log_softmax", "aten.var", "aten.var_mean", "aten.embedding_dense_backward",
          "aten._softmax_backward_data", "aten.one_hot"}
_TRANSCENDENTAL = {"aten.exp", "aten.log", "aten.tanh", "aten.sigmoid", "aten.rsqrt",
                   "aten.sqrt", "aten.sin", "aten.cos", "aten.softplus", "aten.log1p",
                   "aten.expm1", "aten.silu", "aten.pow"}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Count(TorchDispatchMode):
    """Counts the ``meta`` ops run under it (``flops``, ``gemm_flops``,
    ``bytes``, ``hbm_bytes``, ``transcendentals``, ``flops_by_op``), each
    times ``common.trip_factor()``. Ops on another device run and are not
    counted. An op that writes a new tensor is run once per signature (its
    inputs' shapes, strides and dtypes, its other arguments): later calls
    get new ``meta`` tensors of the recorded layouts, which is what makes a
    512-coordinate step a matter of minutes."""

    def __init__(self):
        super().__init__()
        self.flops = self.gemm_flops = self.bytes = self.hbm_bytes = 0
        self.transcendentals = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self._memo: dict = {}
        self._kinds: dict = {}

    def totals(self) -> dict:
        return {"flops": self.flops, "gemm_flops": self.gemm_flops, "bytes": self.bytes,
                "hbm_bytes": self.hbm_bytes, "transcendentals": self.transcendentals}

    def _add(self, name: str, flops: int, rw: int, trans: int, n: int) -> None:
        self.flops += flops * n
        if flops:
            self.flops_by_op[name] += flops * n
            if name in _GEMMS:
                self.gemm_flops += flops * n
        self.bytes += rw * n
        if flops or name.rstrip("_") in _MOVES:
            self.hbm_bytes += rw * n
        self.transcendentals += trans * n

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False  # no compile-disabling wrapper around each op: nothing here compiles

    def _kind(self, func) -> str:
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            kind = ("mutable" if schema.is_mutable else
                    "view" if any(r.alias_info is not None for r in schema.returns) else "new")
            self._kinds[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind(func)
        if kind == "view":  # no work, and nothing to count
            return func(*args, **kwargs)
        tensors: list = []
        key = (func, _sig(args, tensors), _sig(tuple(kwargs.values()), tensors),
               tuple(kwargs))
        if not tensors or not all(t.is_meta for t in tensors):
            return func(*args, **kwargs)
        n = trip_factor()
        try:
            hit = self._memo.get(key) if kind == "new" else None
        except TypeError:  # an argument that does not hash: run it every time
            kind, hit = "unhashable", None
        if hit is not None:
            name, flops, rw, trans, layouts, many = hit
            self._add(name, flops, rw, trans, n)
            outs = [torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in layouts]
            return tuple(outs) if many else outs[0]
        name = str(func._overloadpacket)
        if kind == "new" and func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        formula = flop_registry.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        written = [o for o in outs if isinstance(o, torch.Tensor)]
        rw = sum(_nbytes(t) for t in tensors) + sum(_nbytes(o) for o in written)
        trans = sum(o.numel() for o in written) if name.rstrip("_") in _TRANSCENDENTAL else 0
        self._add(name, flops, rw, trans, n)
        if kind == "new" and len(written) == len(outs) and all(o.is_meta for o in written):
            self._memo[key] = (name, flops, rw, trans,
                               [(tuple(o.shape), o.stride(), o.dtype) for o in written],
                               isinstance(out, (tuple, list)))
        return out


def _sig(args: tuple, tensors: list) -> tuple:
    """A hashable signature of an op's arguments (tensors by layout, which
    are collected into ``tensors``; lists one level deep, as aten's are)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            tensors.append(a)
            out.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            inner = []
            for b in a:
                if isinstance(b, torch.Tensor):
                    tensors.append(b)
                    inner.append((b.shape, b.stride(), b.dtype))
                else:
                    inner.append(b)
            out.append(tuple(inner))
        else:
            out.append(a)
    return tuple(out)


# ------------------------------------------------------------ placement


def spec_bytes(mesh, x: torch.Tensor, spec) -> int:
    """One device's bytes of ``x`` placed by ``spec`` over ``mesh``: each
    split dimension divided (rounded up, as GSPMD pads) by the product of
    its axes' sizes."""
    n = 1
    for d, size in enumerate(x.shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-size // math.prod(mesh.shape[a] for a in axes))
    return n * x.element_size()


def _tree_bytes(mesh, tree, specs) -> int:
    if isinstance(specs, shd.Spec):
        return spec_bytes(mesh, tree, specs)
    if isinstance(tree, dict):
        return sum(_tree_bytes(mesh, tree[k], specs[k]) for k in tree)
    return sum(_tree_bytes(mesh, t, s) for t, s in zip(tree, specs))


def state_bytes(cfg, policy: Policy, opt_cfg: AdamWConfig, mesh) -> tuple[int, int]:
    """One device's bytes of the parameters and of the AdamW state (both
    moments and the int32 step) placed by ``param_pspecs``."""
    named = dict(lm.build(cfg, policy, device="meta").named_parameters())
    specs = shd.param_pspecs(cfg, named)
    mdt = getattr(torch, opt_cfg.moments_dtype)
    return (_tree_bytes(mesh, named, specs),
            4 + 2 * sum(spec_bytes(mesh, x.to(mdt), specs[n]) for n, x in named.items()))


def placement_bytes(cfg, shape_name: str, mesh, policy: Policy, opt_cfg: AdamWConfig,
                    cache_dtype=torch.bfloat16) -> dict:
    """Per-device bytes of the parameters, the optimizer state (both moments
    and the step), the decode cache (decode shapes; 0 otherwise) and the
    batch of one cell, from the specs; nothing is allocated."""
    s = SHAPES[shape_name]
    param, opt = state_bytes(cfg, policy, opt_cfg, mesh)
    out = {"param_bytes": param, "opt_state_bytes": opt, "cache_bytes": 0}
    if s.kind == "decode":
        cache = lm.init_cache(cfg, s.batch, s.seq_len, cache_dtype, device="meta")
        out["cache_bytes"] = _tree_bytes(mesh, cache,
                                         shd.cache_pspecs(cfg, shape_name, mesh, cache))
    out["batch_bytes"] = _tree_bytes(mesh, cfg.input_specs(shape_name, policy.compute_dtype),
                                     shd.batch_pspecs(cfg, shape_name, mesh))
    return out


def block_bytes(tree: dict, coord: tuple) -> int:
    """The bytes of the blocks a placed tree (``Sharded`` leaves) holds at
    ``coord`` by its specs, for checking ``placement_bytes`` against a run."""
    return sum(_nbytes(sh.blocks[sh.index(coord)]) for sh in tree.values())


# ------------------------------------------------------------ running a step


def opt_state_like(p: parallel.MeshLM, opt_cfg: AdamWConfig) -> adamw.AdamWState:
    """Zero moments placed like ``p``'s blocks, on their devices (ZeRO)."""
    mdt = getattr(torch, opt_cfg.moments_dtype)

    def zeros(sh):
        return sh.with_blocks({i: torch.zeros(b.shape, dtype=mdt, device=b.device)
                               for i, b in sh.blocks.items()})

    return adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                            {n: zeros(sh) for n, sh in p.params.items()},
                            {n: zeros(sh) for n, sh in p.params.items()})


def prepare_step(cfg, policy: Policy, opt_cfg: AdamWConfig, p: parallel.MeshLM, kind: str,
                 batch: dict, *, cache: tuple[int, int] | None = None, accum: int = 1,
                 cache_dtype=torch.bfloat16):
    """What one step of a cell needs, placed on ``p``'s mesh (the optimizer
    state; for decode a zero cache of ``cache`` = (rows, positions),
    sequence-sharded when the batch is smaller than the data degree), and
    the step: a function of no arguments that runs it, an AdamW train step,
    a prefill, or a decode step at the cache's last position."""
    if kind == "train":
        opt = opt_state_like(p, opt_cfg)
        step = step_lib.make_train_step(cfg, policy, opt_cfg, warmup_cosine, accum_steps=accum)
        return lambda: step(p, opt, batch)
    if kind == "prefill":
        prefill = step_lib.make_prefill_step(cfg, policy)
        return lambda: prefill(p, batch)
    rows, T = cache
    mc = parallel.place_cache(p, lm.init_cache(cfg, rows, T, cache_dtype, device=p.grid.dev(0, 0)),
                              seq_shard=next(iter(batch.values())).shape[0] < p.grid.D)
    decode = step_lib.make_decode_step(cfg, policy)
    return lambda: decode(p, batch, mc, T - 1)


def count(step) -> dict:
    """Run ``step()`` under ``Count`` and ``watch_transfers``: the whole
    mesh's totals, and ``wall_s``."""
    c = Count()
    moved = collections.Counter()
    times = collections.Counter()

    def note(kind, nbytes, shards):
        if kind == "all-reduce":  # a ring all-reduce: 2 (n - 1) / n s on each of n devices
            moved[kind] += 2 * (shards - 1) * nbytes
            times[kind] += shards
        else:
            moved[kind] += nbytes
            times[kind] += 1

    t0 = time.perf_counter()
    with c, watch_transfers(note):
        step()
    out = c.totals()
    out.update({f"bytes_{k}": v for k, v in moved.items()})
    out["collective_bytes"] = sum(moved.values())
    out["collective_count"] = sum(times.values())
    out["flops_by_op"] = dict(c.flops_by_op)
    out["wall_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ options


@dataclasses.dataclass
class _Knobs:
    accum: int = 1
    cache_dtype: torch.dtype = torch.bfloat16


_GLOBALS = {"wkv_chunk=": (rwkv6, "WKV_CHUNK", int), "moe_cf=": (moe, "CAPACITY_FACTOR", float),
            "moe_group=": (moe, "GROUP_SIZE", int), "loss_chunk=": (lm, "LOSS_CHUNK", int)}


@contextlib.contextmanager
def options(cfg, opts):
    """The reference's ``--opt`` flags applied to ``cfg`` and to the modules'
    globals: yields (cfg, knobs); every global is restored on exit (the
    reference leaks them into later cells)."""
    knobs = _Knobs()
    saved = []

    def put(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    try:
        for o in opts:
            if o == "no_fsdp":
                cfg = dataclasses.replace(cfg, zero_shard_params=False)
            elif o == "fsdp":
                cfg = dataclasses.replace(cfg, zero_shard_params=True)
            elif o == "no_remat":
                cfg = dataclasses.replace(cfg, remat="none")
            elif o.startswith("accum="):
                knobs.accum = int(o.split("=")[1])
            elif o == "kv_int8":
                knobs.cache_dtype = torch.int8
            elif o == "causal_skip":
                put(attention, "CAUSAL_SKIP", True)
            elif o.startswith(("qchunk=", "kvchunk=")):
                raise ValueError(
                    f"--opt {o}: no counterpart in the port; its attention has no query or "
                    "key chunk (the card's kernel tiles itself, the CPU's plain version takes "
                    "whole rows)")
            elif "=" in o and o.split("=")[0] + "=" in _GLOBALS:
                module, name, kind = _GLOBALS[o.split("=")[0] + "="]
                put(module, name, kind(o.split("=")[1]))
            else:
                raise ValueError(f"unknown opt {o!r}")
        yield cfg, knobs
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


# ------------------------------------------------------------ cells


POLICY = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def mesh_of(multi_pod: bool):
    """The reference's production mesh shapes over ``meta`` devices."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, opts=(), cfg=None,
             mesh=None) -> dict:
    """One cell's record (``status`` "ok" or "skipped"; an error raises).
    ``cfg`` and ``mesh`` replace the registry's arch and the production mesh
    (a reduced arch on a small ``meta`` mesh, for tests)."""
    t0 = time.perf_counter()
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    with options(cfg or get_arch(arch), opts) as (cfg, knobs):
        if shape_name not in cfg.runnable_shapes():
            return {**rec, "status": "skipped",
                    "reason": "full-attention arch: long_500k skipped"}
        s = SHAPES[shape_name]
        mesh = mesh or mesh_of(multi_pod)
        n = mesh.size
        rec.update(mesh=mesh.shape, opts=list(opts))
        opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
        rec.update(placement_bytes(cfg, shape_name, mesh, POLICY, opt_cfg, knobs.cache_dtype))
        p = parallel.shard_model(mesh, lm.build(cfg, POLICY, device="meta"))
        step = prepare_step(cfg, POLICY, opt_cfg, p, s.kind,
                            cfg.input_specs(shape_name, POLICY.compute_dtype),
                            cache=(s.batch, s.seq_len), accum=knobs.accum,
                            cache_dtype=knobs.cache_dtype)
        counts = count(step)
    for k, v in counts.items():
        if k != "wall_s" and k != "flops_by_op":
            rec[k] = v / n
    rec["flops_by_op"] = {k: v / n for k, v in counts["flops_by_op"].items()}
    rec["total_collective_bytes"] = rec["collective_bytes"]
    rec["status"] = "ok"
    rec["wall_s"] = time.perf_counter() - t0
    rec["no_counterpart"] = list(NO_COUNTERPART)
    return rec


def _cell(job: tuple) -> tuple[dict, str]:
    """One cell of the sweep, its failure recorded: (record, traceback)."""
    a, sh, mp, opts = job
    try:
        return run_cell(a, sh, mp, opts=opts), ""
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        return ({"arch": a, "shape": sh, "multi_pod": mp, "status": "fail", "opts": list(opts),
                 "error": f"{type(e).__name__}: {str(e)[:2000]}"}, traceback.format_exc(limit=4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (else 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt", action="append", default=[], help="the reference's variant flags")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own (records in order)")
    ap.add_argument("--dump-hlo", default=None, help="no counterpart: raises")
    args = ap.parse_args(argv)
    if args.dump_hlo is not None:
        raise NotImplementedError("--dump-hlo has no counterpart: the port lowers no HLO; "
                                  "its dry-run runs the steps on meta devices")
    with options(get_arch(list_archs()[0]), args.opt):
        pass  # an unknown or unported option raises before any cell runs

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(a, sh, mp, tuple(args.opt)) for a in archs for sh in shapes for mp in meshes]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    n_ok = n_fail = 0
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            import concurrent.futures
            import multiprocessing

            pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1))
            results = pool.map(_cell, jobs)
        else:
            results = map(_cell, jobs)
        for (a, sh, mp, opts), (rec, tb) in zip(jobs, results):
            tag = f"{a} x {sh} x {'2x16x16' if mp else '16x16'}" + (f" {list(opts)}" if opts else "")
            if rec["status"] == "ok":
                n_ok += 1
                print(f"[ok]   {tag}: flops={rec['flops']:.3e} "
                      f"coll={rec['collective_bytes']:.3e}B wall={rec['wall_s']:.1f}s", flush=True)
            elif rec["status"] == "skipped":
                print(f"[skip] {tag}: {rec['reason']}", flush=True)
            else:
                n_fail += 1
                print(f"[FAIL] {tag}: {rec['error'][:300]}\n{tb}", flush=True)
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"done: {n_ok} ok, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
