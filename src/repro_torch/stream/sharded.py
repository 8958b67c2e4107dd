"""Multi-device out-of-core MapReduce: the paper's job layout over a device list.

`core.distributed` runs Algorithms 1 + 2 over a row-sharded resident X;
`stream.lloyd` streams blocks through one device. This module streams the
blocks through several, in one process, one thread per shard:

  shard d of D             <-> mapper d
  store.shard(d, D)        <-> the round-robin block subset mapper d pulls
  BlockPrefetcher(device=) <-> mapper-local ingest (its own producer and queue)
  per-shard (Z, g) fold    <-> the in-mapper combiner
  cross_device_sum         <-> the shuffle: ONE reduction of k * (m + 1) + 1
                               floats a shard per Lloyd iteration
  centroid_update once     <-> the single reducer

A shard is a coordinate of a device list (`shard_devices`), and entries may
repeat: eight ``cpu`` shards are the JAX package's eight forced host
devices, two ``cuda:0`` shards two logical shards on one card. Each shard's
thread maps its blocks under ``torch.cuda.device`` and its own CUDA stream
(`shard_stream`), so two shards of one card overlap their copies and
kernels, and the launches of one shard are ordered on its stream. Before the
threads start, each shard stream waits on the caller's stream (the
centroids and zeros it reads were made there); after they end, the caller's
stream waits on an event recorded on each shard stream, so the caller reads
the accumulators and the pinned label buffer in order, as after one
`map_reduce`.

Memory is O(block) per shard. Exact sharded Lloyd reaches the fixed point of
the single-device `ooc_lloyd` from the same init: the same labels, with
centroids that differ only by the grouping of the float sums. With one
shard the path is inline (no thread, no reduction): `ooc_lloyd` without
devices runs `ooc_lloyd_sharded` over its one device. The sharded mini-batch applies one decayed update per
round of D blocks, so its trajectory is approximate by design.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.lloyd import centroid_update
from repro_torch.device import on_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (  # shard_devices: also this module's name, as in the JAX package
    as_device, cross_device_sum, replicate, shard_devices,
)
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.engine import BlockPrefetcher, cache_embedding, device_name, map_reduce

def shard_names(devices: Sequence) -> list[str]:
    """Each shard's key for its producer lane and ``engine.device_blocks``
    counter: the device's name, with ``/<shard>`` appended when the list
    repeats a device (a one-device run keeps ``cuda:0`` / ``cpu``)."""
    names = [device_name(torch.device(d)) for d in devices]
    if len(set(names)) == len(names):
        return names
    return [f"{name}/{d}" for d, name in enumerate(names)]


_STREAMS: dict[tuple[int, int], "torch.cuda.Stream"] = {}
_STREAMS_LOCK = threading.Lock()


def shard_stream(device: torch.device, shard: int) -> "torch.cuda.Stream":
    """The compute stream of shard ``shard`` on a card, made once and kept:
    the kernels' per-stream scratch (`kernels.lloyd_step.step_launch`) then
    stays one buffer a shard."""
    key = (device.index, shard)
    with _STREAMS_LOCK:
        stream = _STREAMS.get(key)
        if stream is None:
            stream = _STREAMS[key] = torch.cuda.Stream(device)
    return stream


def _shard_context(device: torch.device, shard: int):
    """The card and the shard's stream for a shard's thread; nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(shard_stream(device, shard)))
    return stack


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _run_shards(devices: Sequence[torch.device], run: Callable[[int], Any]) -> list:
    """``run(d)`` for every shard, each on its own thread under its card and
    stream, ordered after the caller's stream and before it again. One shard
    runs inline on the caller's thread and stream."""
    D = len(devices)
    if D == 1:
        with torch.cuda.device(devices[0]) if devices[0].type == "cuda" \
                else contextlib.nullcontext():
            return [run(0)]
    for d, dev in enumerate(devices):
        if dev.type == "cuda":
            shard_stream(dev, d).wait_stream(torch.cuda.current_stream(dev))
    outs: list = [None] * D
    events: list = [None] * D
    errs: list = [None] * D
    names = shard_names(devices)

    def body(d: int) -> None:
        obs.set_lane(f"shard:{names[d]}")
        try:
            with _shard_context(devices[d], d):
                outs[d] = run(d)
                if devices[d].type == "cuda":
                    events[d] = torch.cuda.Event()
                    events[d].record()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            errs[d] = e

    threads = [threading.Thread(target=body, args=(d,), name=f"shard-{names[d]}", daemon=True)
               for d in range(D)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e
    for d, ev in enumerate(events):
        if ev is not None:
            caller = torch.cuda.current_stream(devices[d])
            caller.wait_event(ev)
            for t in _tensors(outs[d]):  # freed later: not before the caller's reads
                if t.device.type == "cuda":
                    t.record_stream(caller)
    return outs


def sharded_map_reduce(
    shards: Sequence[BlockStore],
    map_fns: Sequence[Callable[[Any], Any]],
    combine_fn: Callable[[Any, Any], Any],
    inits: Sequence[Any],
    *,
    devices: Sequence,
    prefetch: int = 2,
    emits: Sequence[Callable[[int, Any], None] | None] | None = None,
    label: str = "map_reduce",
) -> list:
    """One `map_reduce` per shard, concurrently: shard d streams
    ``shards[d]`` through its own producer onto ``devices[d]``, folds its own
    accumulator with ``combine_fn`` and calls ``emits[d]`` in local block
    order. Returns the per-shard accumulators, in shard order; the caller
    owns the cross-device reduction (`cross_device_sum`). ``map_fns[d]``
    must read operands on ``devices[d]``."""
    devices = [as_device(d) for d in devices]
    names = shard_names(devices)

    def run(d: int):
        return map_reduce(shards[d], map_fns[d], combine_fn, inits[d], prefetch=prefetch,
                          emit=emits[d] if emits is not None else None, device=devices[d],
                          label=label, name=names[d])

    return _run_shards(devices, run)


def stream_embed_sharded(
    store: BlockStore,
    coeffs,
    *,
    devices: Sequence,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
):
    """The sharded embed-once pass: shard d embeds ``store.shard(d, D)`` and
    every shard writes into ONE host-staged Y store under the policy's
    ``cache_dtype`` (disjoint global block ids, so the writers never touch
    the same rows). Returns the `WritableBlockStore`."""
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    devices = [as_device(d) for d in devices]
    D = len(devices)
    names = shard_names(devices)
    out = BlockStore.empty(n=store.n, d=coeffs.m, block_rows=store.block_rows,
                           codec=pol.cache_dtype)
    shards = [store.shard(d, D) for d in range(D)]
    coeffs_d = [coeffs.to(dev) for dev in devices]

    def run(d: int):
        cache_embedding(shards[d],
                        lambda x, p=coeffs_d[d]: ops.embed_block_map(x, p, policy=pol),
                        d_out=coeffs.m, out=out, prefetch=prefetch, device=devices[d],
                        name=names[d])

    _run_shards(devices, run)
    return out


# ------------------------------------------------------------ plan map fns
#
# Every per-block map below comes from the one `ops.lloyd_step_plan` the
# single-device drivers use, so under the kernels every backend assigns
# through the same kernel and the stream / stream_shard / pool label
# identities hold at boundary rows too.


def _device_plans(coeffs_d, disc, pol, devices):
    return [ops.lloyd_step_plan(params=coeffs_d[d], discrepancy=disc, policy=pol)
            for d in range(len(devices))]


def _stat_map_fns(coeffs_d, cells, disc, pol, devices):
    """Per-shard (Z, g, labels, cost) maps reading the shard's centroid cell."""
    plans = _device_plans(coeffs_d, disc, pol, devices)
    return [plan.block_map(cell) for plan, cell in zip(plans, cells)]


def _assign_map_fns(coeffs_d, disc, c_locals, pol, devices):
    """Per-shard final-pass (labels, cost) maps under fixed centroids."""
    plans = _device_plans(coeffs_d, disc, pol, devices)
    return [plan.assign_map([c]) for plan, c in zip(plans, c_locals)]


# ------------------------------------------------- pool scheduling policy
#
# The lockstep executor above is one scheduling policy: block -> shard
# placement fixed at fit start, one producer a shard, a cross-device
# reduction an iteration. The pool policy (repro_torch.pool) replaces it with
# leased, reassignable block tasks (any worker runs any block, dead workers'
# leases are requeued, stragglers' unread blocks stolen) and replaces the
# device reduction with a host float32 merge in global block-id order. That
# order is the determinism rule: the merged (Z, g, cost) does not depend on
# which worker ran which block, in what order, or how often, so a chaos run
# reproduces the fault-free pool run bit for bit; pool against lockstep
# differs only by the grouping of the float sums.


def _pool_label_emit(store, labels, index):
    host = labels.buf.numpy()

    def emit(i, out):
        lo = store.row_offset(i)
        new = np.asarray(out[index], dtype=np.int32)
        host[lo:lo + new.shape[0]] = new

    return emit


def _pool_stat_pass(store, map_fns, labels, devices, lease_timeout, label):
    """One fault-tolerant (Z, g, cost) pass: the pool-scheduled map, then the
    host merge in global block-id order."""
    from repro_torch.pool import pool_map_reduce

    outs = pool_map_reduce(store, map_fns, devices=devices, lease_timeout=lease_timeout,
                           emit=_pool_label_emit(store, labels, 2), label=label)
    Z = np.zeros(outs[0][0].shape, np.float32)
    g = np.zeros(outs[0][1].shape, np.float32)
    cost = np.zeros((), np.float32)
    for out in outs:
        Z += out[0]
        g += out[1]
        cost += out[3]
    return Z, g, float(cost)


def _final_assign_pool(store, coeffs_d, disc, c_locals, labels, pol, devices, lease_timeout):
    from repro_torch.pool import pool_map_reduce

    fns = _assign_map_fns(coeffs_d, disc, c_locals, pol, devices)
    outs = pool_map_reduce(store, fns, devices=devices, lease_timeout=lease_timeout,
                           emit=_pool_label_emit(store, labels, 0), label="final_assign_pool")
    cost = np.zeros((), np.float32)
    for out in outs:
        cost += out[1]
    return float(cost)


# ----------------------------------------------------------- Lloyd drivers


def _label_emits(shards, labels, index=2):
    return [(lambda i, out, s=s: labels.put(s.row_offset(i), out[index])) for s in shards]


def _final_assign_sharded(shards, coeffs_d, disc, c_locals, labels, pol, prefetch, devices):
    """Final pass under the final centroids: labels and inertia, one partial
    cost a shard, summed on the host in shard order (the last tiny shuffle)."""
    fns = _assign_map_fns(coeffs_d, disc, c_locals, pol, devices)
    zeros = [torch.zeros((), device=dev) for dev in devices]
    costs = sharded_map_reduce(shards, fns, lambda acc, out: acc + out[1], zeros,
                               devices=devices, prefetch=prefetch,
                               emits=_label_emits(shards, labels, 0))
    return float(sum(float(c) for c in costs))


def _stat_zeros(k, m, devices):
    return [(torch.zeros((k, m), device=dev), torch.zeros((k,), device=dev),
             torch.zeros((), device=dev)) for dev in devices]


def ooc_lloyd_sharded(
    store: BlockStore,
    k: int,
    *,
    coeffs,
    discrepancy,
    iters: int,
    init: torch.Tensor,
    policy: ComputePolicy,
    prefetch: int,
    devices: Sequence,
    scheduler: str = "lockstep",
    checkpoint_dir=None,
    lease_timeout: float = 60.0,
):
    """Exact out-of-core Lloyd across ``devices`` (one or more): the update
    rule and fixed point of the in-memory `core.lloyd.lloyd`, memory O(block)
    a shard. Called through `stream.lloyd.ooc_lloyd`, which resolves the
    devices, the init and the policy.

    scheduler: ``"lockstep"`` keeps the fixed block -> shard placement and
    the device reduction; ``"pool"`` runs every pass through the
    fault-tolerant `repro_torch.pool` plane (leases, requeue, stealing, the
    block-ordered host merge) and survives dead and slow workers.

    checkpoint_dir: the state after every synchronised iteration is saved
    crash-atomically, with ``devices_used=D``; a refit of the same problem
    resumes from it (`launch.elastic.resume_lloyd_state`).

    ``policy.sstep`` > 1 turns on the communication-avoiding s-step variant
    of the lockstep scheduler: each shard updates its own centroids from its
    local (Z, g) for s - 1 iterations and only every s-th iteration (and the
    last) pays the shuffle; the final pass always runs under synchronised
    centroids. The pool scheduler merges every pass and ignores it, as does
    one shard (local is global).
    """
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.elastic import resume_lloyd_state
    from repro_torch.stream.lloyd import StreamLloydResult, _HostLabels

    if scheduler not in ("lockstep", "pool"):
        raise ValueError(f"unknown scheduler {scheduler!r}: expected 'lockstep' or 'pool'")
    devices = [as_device(d) for d in devices]
    D = len(devices)
    disc = coeffs.discrepancy if coeffs is not None else discrepancy
    shards = [store.shard(d, D) for d in range(D)]
    coeffs_d = [coeffs.to(dev) if coeffs is not None else None for dev in devices]
    m = int(init.shape[1])
    sstep = policy.sstep if scheduler == "lockstep" and D > 1 else 1
    c = init.to(devices[0], torch.float32)
    c_locals = replicate(c, devices)
    cells: list[list] = [[None] for _ in range(D)]
    map_fns = _stat_map_fns(coeffs_d, cells, disc, policy, devices)
    labels = _HostLabels(store.n, devices[0], devices)
    prev = labels.numpy().copy()
    emits = _label_emits(shards, labels)

    trajectory: list[float] = []
    shifts: list[float] = []
    it = 0
    changed = True
    fp = None
    if checkpoint_dir is not None:
        fp = ckpt.lloyd_fingerprint(kind="ooc", n=store.n, d=store.d, k=k, m=m, init=init,
                                    cache_dtype=getattr(store, "codec", "f32"))
        state = resume_lloyd_state(checkpoint_dir, fingerprint=fp, devices_used=D)
        if state is not None:
            it, changed = state["step"], state["changed"]
            labels.buf.copy_(torch.from_numpy(state["labels"]))
            prev = state["labels"].copy()
            trajectory, shifts = list(state["trajectory"]), list(state["shifts"])
            c = torch.from_numpy(state["centroids"]).to(devices[0])
            c_locals = replicate(c, devices)

    while it < iters and changed:
        with obs.span("lloyd.iter", cat="lloyd", iter=it, devices=D,
                      scheduler=scheduler) as sp:
            for d in range(D):
                cells[d][0] = c_locals[d]
            if scheduler == "pool":
                Zh, gh, cost = _pool_stat_pass(store, map_fns, labels, devices,
                                               lease_timeout, "lloyd_pool")
                new_c = centroid_update(torch.from_numpy(Zh).to(devices[0]),
                                        torch.from_numpy(gh).to(devices[0]), c)
                shift = float(torch.linalg.norm(new_c - c))
                trajectory.append(cost)
                c = new_c
                c_locals = replicate(c, devices)
                cur = labels.numpy()
                synced = True
            else:
                accs = sharded_map_reduce(
                    shards, map_fns,
                    lambda acc, out: (acc[0] + out[0], acc[1] + out[1], acc[2] + out[3]),
                    _stat_zeros(k, m, devices), devices=devices, prefetch=prefetch,
                    emits=emits)
                cur = labels.numpy()  # every shard's labels of this pass
                # The s-step sync rule: at s-boundaries, and always on the last
                # iteration (cap reached or labels fixed), so the loop never
                # ends on drifted per-shard centroids.
                synced = (sstep == 1 or (it + 1) % sstep == 0 or it + 1 >= iters
                          or np.array_equal(cur, prev))
                if synced:
                    Z, g, cost = cross_device_sum(accs, devices)
                    # Empty clusters keep the last synchronised centroids.
                    new_c = centroid_update(Z, g, c)
                    shift = float(torch.linalg.norm(new_c - c))
                    trajectory.append(float(cost))
                    c = new_c
                    c_locals = replicate(c, devices)
                else:
                    # The deferred shuffle: each shard folds only its own
                    # statistics into its own centroids; the trajectory's cost
                    # is the host sum of the shards' scalar costs, and the
                    # shift is shard 0's (there is no global centroid set
                    # between syncs).
                    new_locals = [centroid_update(accs[d][0], accs[d][1], c_locals[d])
                                  for d in range(D)]
                    trajectory.append(sum(float(accs[d][2]) for d in range(D)))
                    shift = float(torch.linalg.norm(new_locals[0] - c_locals[0]))
                    c_locals = new_locals
            shifts.append(shift)
            sp.set(inertia=trajectory[-1], shift=shift, synced=synced)
        changed = not np.array_equal(cur, prev)
        prev = cur.copy()
        it += 1
        if checkpoint_dir is not None and synced:
            ckpt.save_lloyd_state(
                checkpoint_dir, step=it, centroids=c, labels=prev, trajectory=trajectory,
                shifts=shifts, changed=changed, fingerprint=fp, devices_used=D,
            )

    c_locals = replicate(c, devices)
    if scheduler == "pool":
        from repro_torch.pool.executor import drain_stale

        inertia = _final_assign_pool(store, coeffs_d, disc, c_locals, labels, policy, devices,
                                     lease_timeout)
        # Join workers still draining a re-executed block, so that the engine
        # counts (and the FitReport built from them) are final on return.
        drain_stale()
    else:
        inertia = _final_assign_sharded(shards, coeffs_d, disc, c_locals, labels, policy,
                                        prefetch, devices)
    trajectory.append(inertia)
    return StreamLloydResult(
        labels.numpy().copy(), c, inertia, it, (it + 1) * store.n,
        tuple(trajectory), tuple(shifts),
    )


def minibatch_lloyd_sharded(
    store: BlockStore,
    k: int,
    *,
    coeffs,
    discrepancy,
    decay: float,
    epochs: int,
    init: torch.Tensor,
    policy: ComputePolicy,
    prefetch: int,
    devices: Sequence,
    checkpoint_dir=None,
):
    """Per-shard mini-batch Lloyd (Chitta et al., sharded): each round, every
    shard assigns ONE of its blocks under the current centroids; the round's
    per-shard statistics are reduced once and folded into the decayed global
    (Z, g); the centroids move once a round of D blocks. A shard whose blocks
    are exhausted contributes zeros to the ragged last rounds.
    ``checkpoint_dir``: the state, decayed (Z, g) included, after every
    epoch."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.elastic import resume_lloyd_state
    from repro_torch.stream.lloyd import StreamLloydResult, _HostLabels

    devices = [as_device(d) for d in devices]
    D = len(devices)
    dev0 = devices[0]
    disc = coeffs.discrepancy if coeffs is not None else discrepancy
    shards = [store.shard(d, D) for d in range(D)]
    names = shard_names(devices)
    coeffs_d = [coeffs.to(dev) if coeffs is not None else None for dev in devices]
    m = int(init.shape[1])
    c = init.to(dev0, torch.float32)
    cells: list[list] = [[None] for _ in range(D)]
    map_fns = _stat_map_fns(coeffs_d, cells, disc, policy, devices)
    Z, g = torch.zeros((k, m), device=dev0), torch.zeros((k,), device=dev0)
    labels = _HostLabels(store.n, dev0, devices)

    trajectory: list[float] = []
    start = 0
    fp = None
    if checkpoint_dir is not None:
        fp = ckpt.lloyd_fingerprint(kind="minibatch", n=store.n, d=store.d, k=k, m=m,
                                    init=init, decay=decay,
                                    cache_dtype=getattr(store, "codec", "f32"))
        state = resume_lloyd_state(checkpoint_dir, fingerprint=fp, devices_used=D)
        if state is not None:
            start = state["step"]
            labels.buf.copy_(torch.from_numpy(state["labels"]))
            trajectory = list(state["trajectory"])
            c = torch.from_numpy(state["centroids"]).to(dev0)
            Z = torch.from_numpy(state["stats"]["Z"]).to(dev0)
            g = torch.from_numpy(state["stats"]["g"]).to(dev0)
    for ep in range(start, epochs):
        epoch_cost = 0.0
        with obs.span("lloyd.epoch", cat="lloyd", epoch=ep, devices=D) as sp:
            pfs = [BlockPrefetcher(shards[d], prefetch=max(1, prefetch), device=devices[d],
                                   name=names[d]) for d in range(D)]
            try:
                while True:
                    for d, cd in enumerate(replicate(c, devices)):
                        cells[d][0] = cd
                    stats = _stat_zeros(k, m, devices)
                    seen = 0
                    for d in range(D):
                        with on_device(devices[d]):
                            item = next(pfs[d], None)
                            if item is None:
                                continue
                            i, blk = item
                            out = map_fns[d](blk)
                        stats[d] = (out[0], out[1], out[3])
                        labels.put(shards[d].row_offset(i), out[2])
                        seen += 1
                    if not seen:
                        break
                    Zb, gb, costb = cross_device_sum(stats, devices)
                    Z = decay * Z + Zb
                    g = decay * g + gb
                    c = centroid_update(Z, g, c)
                    epoch_cost += float(costb)
            finally:
                for pf in pfs:
                    pf.close()
            trajectory.append(epoch_cost)
            sp.set(inertia=epoch_cost)
        if checkpoint_dir is not None:
            ckpt.save_lloyd_state(
                checkpoint_dir, step=ep + 1, centroids=c, labels=labels.numpy(),
                trajectory=trajectory, shifts=[], changed=True, fingerprint=fp,
                devices_used=D, stats={"Z": Z, "g": g},
            )

    inertia = _final_assign_sharded(shards, coeffs_d, disc, replicate(c, devices), labels,
                                    policy, prefetch, devices)
    trajectory.append(inertia)
    return StreamLloydResult(
        labels.numpy().copy(), c, inertia, epochs, (epochs + 1) * store.n,
        tuple(trajectory), (),
    )
