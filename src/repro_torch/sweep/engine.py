"""Multi-candidate Lloyd drivers over a cached embedding.

Running R restarts x a k-grid as independent fits pays the embedding
R * |k_grid| * (iters + 1) times. These drivers pay it zero times: they
iterate over already-embedded Y (the cache of `ensure_embedding_cache`) and
feed every candidate from each engine pass:

  * `sweep_lloyd`: one stream of Y blocks per iteration; per block, per
    still-active (k, restart) candidate, one Y-mode plan step, so each
    restart runs the identical kernel `ooc_lloyd` runs (`fused_dequant_step`
    over a compressed cache, `apnc_assign` over f32);
  * `sweep_lloyd_local`: resident-Y candidates through `core.lloyd.lloyd`,
    the calls the local backend makes, minus its embedding;
  * `sweep_lloyd_sharded`: the same lattice across several devices: shard d
    streams the round-robin Y shard ``y_store.shard(d, D)`` on its own thread
    and stream, and every pass reduces the whole active lattice's (Z, g) in
    ONE `cross_device_sum`, as `ooc_lloyd`'s sharded driver does for one
    candidate.

Each candidate's update sequence is the single-candidate driver's (the same
per-block sums from the same zeros, the same centroid update, the same final
assignment under the final centroids, the same stopping rule: whole passes
compared, one sync a pass), so `sweep(k_grid=[k], restarts=1)` reproduces
`fit(k)` label for label. A candidate whose labels stop changing is at a
Lloyd fixed point: its later passes would recompute the same statistics, so
the engine stops dispatching it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.lloyd import centroid_update, lloyd
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.engine import map_reduce
from repro_torch.stream.lloyd import _HostLabels


class SweepLloydOut(NamedTuple):
    """Raw result of one multi-candidate run (the orchestrator wraps it)."""

    labels: list  # [k_index][restart] -> (n,) int32 host labels
    centroids: list  # [k_index] -> (R, k_i, m) final centroids
    inertia: np.ndarray  # (len(k_grid), R) float
    iters: np.ndarray  # (len(k_grid), R) iterations run per candidate
    passes: int  # Lloyd engine passes over the cached Y (the final assign not counted)


def sweep_lloyd(
    y_store: BlockStore,
    inits: Sequence[torch.Tensor],
    discrepancy: str,
    *,
    iters: int,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
) -> SweepLloydOut:
    """Exact multi-candidate Lloyd over cached Y blocks on one device.

    ``inits[i]`` is the (R_i, k_i, m) stack of restart seeds of k-grid entry
    i. Per iteration one pass streams every Y block (in its codec's wire
    form); per block, one plan step per still-active candidate. Labels go
    into one pinned host buffer per candidate without a sync per block; the
    pass synchronizes once and each candidate compares its whole pass with
    the previous one, as `ooc_lloyd` does.
    """
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    dev = resolve_device(device)
    plan = ops.lloyd_step_plan(discrepancy=discrepancy, policy=pol)
    K = len(inits)
    n = y_store.n
    cents = [[c.to(dev, torch.float32) for c in stack] for stack in inits]
    R_of = [len(stack) for stack in cents]
    labels = [[_HostLabels(n, dev) for _ in range(R_of[i])] for i in range(K)]
    prev = [[labels[i][r].numpy().copy() for r in range(R_of[i])] for i in range(K)]
    iters_run = np.zeros((K, max(R_of)), dtype=np.int64)
    active = [(i, r) for i in range(K) for r in range(R_of[i])]

    passes = 0
    while passes < iters and active:
        act = list(active)

        def map_fn(block, act=act):
            return [plan.step(block, cents[i][r]) for i, r in act]

        def emit(b, outs, act=act):
            lo = y_store.row_offset(b)
            for (i, r), out in zip(act, outs):
                labels[i][r].put(lo, out[2])

        zero = [(torch.zeros(cents[i][r].shape, device=dev),
                 torch.zeros((cents[i][r].shape[0],), device=dev)) for i, r in act]
        stats = map_reduce(
            y_store, map_fn,
            lambda acc, outs: [(a[0] + o[0], a[1] + o[1]) for a, o in zip(acc, outs)],
            zero, prefetch=prefetch, emit=emit, device=dev, label="sweep_lloyd",
        )
        active = []
        for (i, r), (Z, g) in zip(act, stats):
            cents[i][r] = centroid_update(Z, g, cents[i][r])
            iters_run[i, r] += 1
            cur = labels[i][r].numpy()  # the first one synchronizes the pass
            if not np.array_equal(cur, prev[i][r]):
                prev[i][r] = cur.copy()
                active.append((i, r))
        passes += 1

    # Final pass under the final centroids: labels and inertia of every
    # candidate, as `ooc_lloyd`'s final assign gives them.
    every = [(i, r) for i in range(K) for r in range(R_of[i])]

    def final_emit(b, outs):
        lo = y_store.row_offset(b)
        for (i, r), out in zip(every, outs):
            labels[i][r].put(lo, out[0])

    costs = map_reduce(
        y_store, lambda block: [plan.assign(block, cents[i][r]) for i, r in every],
        lambda acc, outs: [a + o[1] for a, o in zip(acc, outs)],
        [torch.zeros((), device=dev) for _ in every],
        prefetch=prefetch, emit=final_emit, device=dev, label="sweep_lloyd",
    )
    inertia = np.zeros((K, max(R_of)), dtype=np.float64)
    for (i, r), cost in zip(every, costs):
        inertia[i, r] = float(cost)
    host = [[labels[i][r].numpy().copy() for r in range(R_of[i])] for i in range(K)]
    return SweepLloydOut(host, [torch.stack(c) for c in cents], inertia, iters_run, passes)


def sweep_lloyd_local(
    Y: torch.Tensor,
    inits: Sequence[torch.Tensor],
    discrepancy: str,
    *,
    iters: int,
    policy: ComputePolicy | None = None,
) -> SweepLloydOut:
    """Resident-Y candidates: the `core.lloyd.lloyd` calls the local backend
    makes, minus its embedding."""
    K = len(inits)
    R = max(int(c.shape[0]) for c in inits)
    labels: list = []
    cents: list = []
    inertia = np.zeros((K, R), dtype=np.float64)
    iters_run = np.zeros((K, R), dtype=np.int64)
    for i, C in enumerate(inits):
        k_labels, k_cents = [], []
        for r in range(int(C.shape[0])):
            res = lloyd(Y, int(C.shape[1]), discrepancy=discrepancy, iters=iters,
                        init=C[r].to(Y.device), policy=policy)
            k_labels.append(res.labels.cpu().numpy().astype(np.int32))
            k_cents.append(res.centroids)
            inertia[i, r] = float(res.inertia)
            iters_run[i, r] = int(res.iters)
        labels.append(k_labels)
        cents.append(torch.stack(k_cents))
    return SweepLloydOut(labels, cents, inertia, iters_run, int(iters_run.max()))


def sweep_lloyd_sharded(
    y_store: BlockStore,
    inits: Sequence[torch.Tensor],
    discrepancy: str,
    *,
    iters: int,
    devices: Sequence,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
) -> SweepLloydOut:
    """Exact multi-candidate Lloyd over cached Y blocks across ``devices``
    (a device list, entries may repeat): per pass, shard d streams
    ``y_store.shard(d, D)`` and steps every still-active candidate on each
    of its blocks (`fused_dequant_step` over a compressed cache on a card);
    the shards' statistics of the whole lattice are reduced once, and each
    candidate's centroids update once on the first device. Labels, stopping
    rule and final assignment are `sweep_lloyd`'s; a candidate's fixed point
    is that of ``ooc_lloyd(devices=...)`` from its init."""
    from repro_torch.launch.mesh import as_device
    from repro_torch.stream.sharded import cross_device_sum, replicate, sharded_map_reduce

    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    devices = [as_device(d) for d in devices]
    D = len(devices)
    dev0 = devices[0]
    shards = [y_store.shard(d, D) for d in range(D)]
    plan = ops.lloyd_step_plan(discrepancy=discrepancy, policy=pol)
    K = len(inits)
    n = y_store.n
    cents = [[c.to(dev0, torch.float32) for c in stack] for stack in inits]
    R_of = [len(stack) for stack in cents]
    labels = [[_HostLabels(n, dev0, devices) for _ in range(R_of[i])] for i in range(K)]
    prev = [[labels[i][r].numpy().copy() for r in range(R_of[i])] for i in range(K)]
    iters_run = np.zeros((K, max(R_of)), dtype=np.int64)
    active = [(i, r) for i in range(K) for r in range(R_of[i])]

    def emits_of(cands, index):
        def make(shard):
            def emit(b, outs):
                lo = shard.row_offset(b)
                for (i, r), out in zip(cands, outs):
                    labels[i][r].put(lo, out[index])

            return emit

        return [make(s) for s in shards]

    passes = 0
    while passes < iters and active:
        act = list(active)
        local = {c: replicate(cents[c[0]][c[1]], devices) for c in act}
        map_fns = [(lambda block, d=d: [plan.step(block, local[c][d]) for c in act])
                   for d in range(D)]
        zeros = [[(torch.zeros(cents[i][r].shape, device=dev),
                   torch.zeros((cents[i][r].shape[0],), device=dev)) for i, r in act]
                 for dev in devices]
        accs = sharded_map_reduce(
            shards, map_fns,
            lambda acc, outs: [(a[0] + o[0], a[1] + o[1]) for a, o in zip(acc, outs)],
            zeros, devices=devices, prefetch=prefetch, emits=emits_of(act, 2),
            label="sweep_lloyd",
        )
        stats = cross_device_sum(accs, devices)
        active = []
        for (i, r), (Z, g) in zip(act, stats):
            cents[i][r] = centroid_update(Z, g, cents[i][r])
            iters_run[i, r] += 1
            cur = labels[i][r].numpy()
            if not np.array_equal(cur, prev[i][r]):
                prev[i][r] = cur.copy()
                active.append((i, r))
        passes += 1

    # Final pass under the final centroids: every candidate's labels, and its
    # inertia as one partial cost a shard, summed on the host in shard order.
    every = [(i, r) for i in range(K) for r in range(R_of[i])]
    local = {c: replicate(cents[c[0]][c[1]], devices) for c in every}
    costs = sharded_map_reduce(
        shards,
        [(lambda block, d=d: [plan.assign(block, local[c][d]) for c in every])
         for d in range(D)],
        lambda acc, outs: [a + o[1] for a, o in zip(acc, outs)],
        [[torch.zeros((), device=dev) for _ in every] for dev in devices],
        devices=devices, prefetch=prefetch, emits=emits_of(every, 0), label="sweep_lloyd",
    )
    inertia = np.zeros((K, max(R_of)), dtype=np.float64)
    for j, (i, r) in enumerate(every):
        inertia[i, r] = sum(float(costs[d][j]) for d in range(D))
    host = [[labels[i][r].numpy().copy() for r in range(R_of[i])] for i in range(K)]
    return SweepLloydOut(host, [torch.stack(c) for c in cents], inertia, iters_run, passes)
