"""Streaming Lloyd drivers on top of the block engine.

Two regimes, both O(block) in device memory and both sharing the reduce step
of `core.lloyd` (`centroid_update`):

  * `ooc_lloyd`: exact out-of-core Lloyd. Per iteration, stream every block,
    accumulate the global (Z, g), update the centroids once. Same fixed point
    as the in-memory `core.lloyd.lloyd` from the same init: only the
    summation grouping of Z differs.
  * `minibatch_lloyd`: single-pass streaming Lloyd with decayed sufficient
    statistics Z <- gamma Z + Z_b, for streams where "iterate until
    convergence" is not an option.

Blocks hold raw inputs X (pass `coeffs=`, the fitted params of any registered
member: each block is embedded and assigned in one fused kernel where the
member has one) or embedded rows Y (pass `discrepancy=`; `stream_embed`
stages Y blocks to host memory once, under the policy's `cache_dtype`; a
compressed store streams in its wire form and each block's step decodes it
inside `fused_dequant_step`).

Labels live on the host, (n,) int32: on a card each block's labels are
copied into pinned memory without a sync, and the pass synchronizes once.
These drivers back the "stream", "stream_shard" and "minibatch" backends of
`repro_torch.api.KernelKMeans`. ``devices=`` (a device list, entries may
repeat) or ``mesh=`` (its data-axis devices) routes a run through
`repro_torch.stream.sharded`: each shard streams a round-robin block subset
through its own producer, thread and CUDA stream, and the per-shard (Z, g)
are reduced once an iteration; ``scheduler="pool"`` runs the passes through
the fault-tolerant `repro_torch.pool` plane instead. `checkpoint_dir=`
saves the state after every iteration (epoch for minibatch)
crash-atomically, and a refit with the same data, k and init resumes from
it and reaches the uninterrupted fit's labels, iterations and inertia bit
for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.apnc import Discrepancy
from repro_torch.core.lloyd import centroid_update, kmeanspp_init
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.embed.base import EmbeddingParams
from repro_torch.kernels import ops
from repro_torch.launch.elastic import resume_lloyd_state
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.stream.blockstore import BlockStore, WritableBlockStore
from repro_torch.stream.engine import cache_embedding, map_reduce
from repro_torch.stream.reservoir import reservoir_sample


class StreamLloydResult(NamedTuple):
    labels: np.ndarray  # (n,) int32, host-resident
    centroids: torch.Tensor  # (k, m)
    inertia: float  # sum of e(y_i, c_{pi(i)})
    iters: int  # iterations actually run
    rows_seen: int  # total rows streamed ((iters + 1) * n for exact)
    # Per-iteration inertia (exact: the cost of iteration t's assignment;
    # minibatch: per-epoch accumulated block costs), last entry the final
    # pass's, and per-update centroid shifts ||c_{t+1} - c_t||_F.
    trajectory: tuple = ()
    shifts: tuple = ()


class _HostLabels:
    """(n,) int32 labels on the host. On a card the buffer is pinned and each
    block's labels are copied into it on the compute stream without a sync;
    ``numpy()`` synchronizes the current stream of ``device`` (of every card
    in ``devices``, for the shards of a sharded run, whose streams the
    current ones wait on) once and returns a view of the buffer. Shards write
    disjoint rows, so they share one buffer."""

    def __init__(self, n: int, device: torch.device, devices=None):
        self.devices = sorted({d for d in (devices or [device]) if d.type == "cuda"},
                              key=str)
        self.buf = torch.full((n,), -1, dtype=torch.int32,
                              pin_memory=device.type == "cuda")

    def put(self, lo: int, labels: torch.Tensor) -> None:
        self.buf[lo:lo + labels.shape[0]].copy_(labels, non_blocking=True)

    def numpy(self) -> np.ndarray:
        for dev in self.devices:
            torch.cuda.current_stream(dev).synchronize()
        return self.buf.numpy()


def _resolve_devices(devices, mesh):
    """The sharded path's trigger: an explicit device list wins, a mesh gives
    its data-axis devices, neither keeps the single-device driver."""
    if devices is not None and mesh is not None:
        raise ValueError("pass at most one of devices= and mesh=")
    if devices is not None:
        from repro_torch.launch.mesh import as_device

        return [as_device(d) for d in devices]
    if mesh is not None:
        from repro_torch.stream.sharded import shard_devices

        return shard_devices(mesh)
    return None


def _source(coeffs, discrepancy) -> str:
    if (coeffs is None) == (discrepancy is None):
        raise ValueError("pass exactly one of coeffs= (raw X blocks) or discrepancy= (Y blocks)")
    return coeffs.discrepancy if coeffs is not None else discrepancy


def stream_embed(
    store: BlockStore,
    coeffs: EmbeddingParams,
    *,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
    devices=None,
    mesh=None,
) -> WritableBlockStore:
    """Algorithm 1 over a block stream: X blocks in, Y blocks staged to host
    memory under the policy's ``cache_dtype`` codec (O(n*m) host, O(block)
    device). Use when host memory holds Y and several Lloyd iterations will
    reuse it. ``devices=`` / ``mesh=`` shard the pass
    (`stream.sharded.stream_embed_sharded`), every shard writing into the
    one staged store."""
    pol = as_policy(policy)
    devs = _resolve_devices(devices, mesh)
    if devs is not None:
        from repro_torch.stream.sharded import stream_embed_sharded

        return stream_embed_sharded(store, coeffs, devices=devs, policy=pol, prefetch=prefetch)
    return cache_embedding(
        store, lambda x: ops.embed_block_map(x, coeffs, policy=pol), d_out=coeffs.m,
        codec=pol.cache_dtype, prefetch=pol.prefetch if prefetch is None else prefetch,
        device=device,
    )


def _resolve_init(store, coeffs, discrepancy, k, init, generator, seed_sample, dev,
                  policy=None):
    if init is not None:
        return torch.as_tensor(init).to(dev, torch.float32)
    if generator is None:
        raise ValueError("provide generator= for k-means++ init or init= centroids")
    # One draw picks WHICH rows the reservoir keeps, the rest HOW k-means++
    # seeds among them.
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    sample = torch.from_numpy(reservoir_sample(store, seed_sample, seed=seed)).to(
        dev, torch.float32)
    if coeffs is not None:  # raw X rows: embed the reservoir before seeding
        sample = ops.embed_block_map(sample, coeffs, policy=policy)
    return kmeanspp_init(generator, sample, k, discrepancy, policy)


def ooc_lloyd(
    store: BlockStore,
    k: int,
    *,
    coeffs: EmbeddingParams | None = None,
    discrepancy: Discrepancy | None = None,
    iters: int = 20,
    init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    seed_sample: int = 1024,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
    devices=None,
    mesh=None,
    scheduler: str = "lockstep",
    checkpoint_dir=None,
    lease_timeout: float = 60.0,
) -> StreamLloydResult:
    """Exact out-of-core Lloyd: the update rule of `core.lloyd.lloyd`, memory
    O(block) on ``device`` (default: the card; ``"cpu"`` for the plain path).
    Stops early when no label changes, then assigns once more under the final
    centroids. ``init`` centroids, or a CPU ``generator`` for a k-means++
    init on a reservoir sample of ``seed_sample`` rows. ``checkpoint_dir``
    saves the state after every iteration and resumes a refit of the same
    data, k and init from the last one saved.

    One driver runs every case (`stream.sharded.ooc_lloyd_sharded`): one
    device is one shard, run inline on the caller's thread and stream.
    ``devices=`` / ``mesh=`` shard the stream (the init is resolved on the
    first shard's device): the same fixed point, O(block) a shard.
    ``scheduler`` picks the sharded pass executor, ``"lockstep"`` (fixed
    placement, one device reduction an iteration) or ``"pool"`` (the leased
    tasks of `repro_torch.pool`, with ``lease_timeout`` seconds a lease);
    ``"pool"`` without devices raises."""
    disc = _source(coeffs, discrepancy)
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    devs = _resolve_devices(devices, mesh)
    if devs is None:
        if scheduler != "lockstep":
            raise ValueError(
                f"scheduler={scheduler!r} needs devices=/mesh=: one device has no worker pool")
        devs = [resolve_device(device)]
    c0 = _resolve_init(store, coeffs, disc, k, init, generator, seed_sample, devs[0], pol)
    from repro_torch.stream.sharded import ooc_lloyd_sharded

    return ooc_lloyd_sharded(
        store, k, coeffs=coeffs, discrepancy=discrepancy, iters=iters, init=c0,
        policy=pol, prefetch=prefetch, devices=devs, scheduler=scheduler,
        checkpoint_dir=checkpoint_dir, lease_timeout=lease_timeout,
    )


def _final_assign(store, coeffs, disc, cell, labels: _HostLabels, prefetch, dev,
                  policy=None) -> float:
    """Final labels + inertia under the final centroids: one plan ``assign``
    per block (labels at index 0, cost at 1)."""
    plan = ops.lloyd_step_plan(params=coeffs, discrepancy=disc, policy=policy)

    def emit(i, out):
        labels.put(store.row_offset(i), out[0])

    inertia = map_reduce(
        store, plan.assign_map(cell), lambda acc, out: acc + out[1],
        torch.zeros((), device=dev), prefetch=prefetch, emit=emit, device=dev,
    )
    return float(inertia)


def minibatch_lloyd(
    store: BlockStore,
    k: int,
    *,
    coeffs: EmbeddingParams | None = None,
    discrepancy: Discrepancy | None = None,
    decay: float = 0.9,
    epochs: int = 1,
    init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    seed_sample: int = 1024,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
    devices=None,
    mesh=None,
    checkpoint_dir=None,
) -> StreamLloydResult:
    """Single-pass (per epoch) streaming Lloyd with decayed sufficient stats:

        Z <- decay * Z + Z_b,   g <- decay * g + g_b,   c = Z / g

    The centroids move after every block, so one pass over the stream
    already clusters; decay < 1 forgets stale assignments.
    ``checkpoint_dir`` saves the state, (Z, g) included, after every epoch
    and resumes a refit of the same data, k, init and decay from the last
    one saved. ``devices=`` / ``mesh=`` shard the stream: one block a shard
    a round, one decayed update a round (`stream.sharded`)."""
    disc = _source(coeffs, discrepancy)
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    devs = _resolve_devices(devices, mesh)
    dev = devs[0] if devs is not None else resolve_device(device)
    cell = [_resolve_init(store, coeffs, disc, k, init, generator, seed_sample, dev, pol)]
    if devs is not None:
        from repro_torch.stream.sharded import minibatch_lloyd_sharded

        return minibatch_lloyd_sharded(
            store, k, coeffs=coeffs, discrepancy=discrepancy, decay=decay, epochs=epochs,
            init=cell[0], policy=pol, prefetch=prefetch, devices=devs,
            checkpoint_dir=checkpoint_dir,
        )
    m = int(cell[0].shape[1])
    map_fn = ops.lloyd_step_plan(params=coeffs, discrepancy=disc, policy=pol).block_map(cell)
    labels = _HostLabels(store.n, dev)
    state = [torch.zeros((k, m), device=dev), torch.zeros((k,), device=dev),
             torch.zeros((), device=dev)]

    def emit(i, out):
        labels.put(store.row_offset(i), out[2])

    def combine(acc, out):
        Z = decay * state[0] + out[0]
        g = decay * state[1] + out[1]
        state[0], state[1], state[2] = Z, g, state[2] + out[3]
        cell[0] = centroid_update(Z, g, cell[0])
        return acc

    # Per-epoch trajectory: the accumulated block costs of that epoch, each
    # under the centroids current when its block streamed.
    trajectory: list[float] = []
    seen_cost = 0.0
    start = 0
    fp = None
    if checkpoint_dir is not None:
        fp = ckpt.lloyd_fingerprint(kind="minibatch", n=store.n, d=store.d, k=k, m=m,
                                    init=cell[0], decay=decay,
                                    cache_dtype=getattr(store, "codec", "f32"))
        saved = resume_lloyd_state(checkpoint_dir, fingerprint=fp, devices_used=1)
        if saved is not None:
            start = saved["step"]
            labels.buf.copy_(torch.from_numpy(saved["labels"]))
            trajectory = list(saved["trajectory"])
            cell[0] = torch.from_numpy(saved["centroids"]).to(dev)
            state[:] = [torch.from_numpy(saved["stats"][name]).to(dev)
                        for name in ("Z", "g", "seen_cost")]
            seen_cost = float(state[2])
    for ep in range(start, epochs):
        with obs.span("lloyd.epoch", cat="lloyd", epoch=ep) as sp:
            map_reduce(store, map_fn, combine, None, prefetch=prefetch, emit=emit, device=dev)
            total = float(state[2])
            trajectory.append(total - seen_cost)
            seen_cost = total
            sp.set(inertia=trajectory[-1])
        if checkpoint_dir is not None:
            ckpt.save_lloyd_state(
                checkpoint_dir, step=ep + 1, centroids=cell[0], labels=labels.numpy(),
                trajectory=trajectory, shifts=[], changed=True, fingerprint=fp,
                devices_used=1, stats={"Z": state[0], "g": state[1], "seen_cost": state[2]},
            )

    inertia = _final_assign(store, coeffs, disc, cell, labels, prefetch, dev, pol)
    trajectory.append(inertia)
    return StreamLloydResult(  # +1 pass: the final assign streams everything again
        labels.numpy().copy(), cell[0], inertia, epochs, (epochs + 1) * store.n,
        tuple(trajectory), (),
    )


def stream_fit_predict(
    seed: int,
    store: BlockStore,
    kernel,
    k: int,
    cfg=None,
    *,
    mode: str = "exact",
    landmark_sample: int = 4096,
    decay: float = 0.9,
    epochs: int = 1,
    prefetch: int | None = None,
    device=None,
):
    """End-to-end embed-and-conquer over a block stream:

    1. reservoir-sample rows for landmark selection (one pass),
    2. fit the embedding on the sample (tiny and resident, as in the paper, P4.3),
    3. cluster the stream: exact out-of-core Lloyd (``mode="exact"``) or
       single-pass mini-batch (``"minibatch"``), the embedding fused into the
       per-block step (Y never materializes).

    ``seed`` splits three ways (``phase1_seeds``): which rows the reservoir
    keeps, the embedding fit's draws, and the clustering's k-means++ draws,
    so landmark selection is not correlated with the embedding's own
    randomness. ``cfg`` is a `core.kkmeans.APNCConfig`. Runs on ``device``
    (default: the card). Returns (StreamLloydResult, params).
    """
    from repro_torch.api.estimator import phase1_seeds
    from repro_torch.core import kkmeans

    cfg = cfg or kkmeans.APNCConfig()
    pol = cfg.compute
    dev = resolve_device(device)
    s_sample, s_fit, s_cluster = phase1_seeds(seed)
    sample = torch.from_numpy(reservoir_sample(store, landmark_sample, seed=s_sample)).to(
        dev, torch.float32)
    coeffs = kkmeans.fit_coefficients(s_fit, sample, kernel, cfg)
    common = dict(coeffs=coeffs, generator=torch.Generator().manual_seed(s_cluster),
                  policy=pol, prefetch=prefetch, device=dev)
    if mode == "exact":
        res = ooc_lloyd(store, k, iters=cfg.iters, **common)
    elif mode == "minibatch":
        res = minibatch_lloyd(store, k, decay=decay, epochs=epochs, **common)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return res, coeffs
