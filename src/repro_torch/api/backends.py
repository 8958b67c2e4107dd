"""Execution backends behind `KernelKMeans`.

Each backend receives the same prepared inputs (a FitContext) and returns the
same result shape (a BackendFit):

  local        embed everything, then Lloyd per restart over the resident Y
  shard_map    Algorithms 1 + 2 over the row shards of a resident X on a
               device mesh (core.distributed)
  stream       exact out-of-core Lloyd over row blocks (stream.ooc_lloyd): the
               same fixed point as local from the same init, device memory
               O(block)
  stream_shard exact out-of-core Lloyd with the block stream sharded across
               the mesh's data devices (stream.sharded): the fixed point of
               stream, O(block) a shard
  minibatch    single-pass streaming Lloyd with decayed (Z, g)
               (stream.minibatch_lloyd)

Because every backend clusters from the same embedding params and the same
init centroids, local and stream reach identical labels.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.registry import register_backend
from repro_torch.core.lloyd import lloyd
from repro_torch.embed.base import EmbeddingParams
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.lloyd import minibatch_lloyd, ooc_lloyd, stream_embed


@dataclasses.dataclass
class FitContext:
    """Everything a clustering backend needs, prepared once by the estimator."""

    store: BlockStore  # blocked host view of the data (always present)
    array: torch.Tensor | None  # the resident array on the fit's device, local backend only
    params: EmbeddingParams  # fitted params of the registered embedding member
    k: int
    inits: list[torch.Tensor]  # k-means++ init centroids, one per restart
    iters: int
    policy: ComputePolicy
    device: torch.device | None = None  # where blocks are mapped; None: the params' device
    decay: float = 0.9  # minibatch: sufficient-stat decay
    epochs: int = 1  # minibatch: passes over the stream
    # Embed-once cache: when set, backends cluster over the embedded data
    # instead of embedding X again on every pass.
    y_store: BlockStore | None = None  # host-staged Y blocks (blocked input)
    y_array: torch.Tensor | None = None  # resident f32 Y (resident input)
    # Root directory of the stream backends' mid-fit Lloyd checkpoints, one
    # subdirectory a restart (None: no checkpoints; local ignores it).
    checkpoint_dir: Any | None = None
    # The sharded backends' `launch.mesh.Mesh` (None: stream_shard takes every
    # visible card, or [cpu] on the CPU; shard_map one device), and
    # stream_shard's pass scheduling: "lockstep" or "pool".
    mesh: Any | None = None
    scheduler: str = "lockstep"

    def __post_init__(self):
        if self.device is None:
            self.device = self.params.device


def _restart_ckpt(ctx: FitContext, r: int):
    """Restart r's checkpoint subdirectory: restarts have different inits
    (distinct fingerprints), so one shared state directory would thrash its
    keep_last rotation."""
    if ctx.checkpoint_dir is None:
        return None
    return Path(ctx.checkpoint_dir) / f"restart_{r}"


@dataclasses.dataclass
class BackendFit:
    """Uniform raw result of one backend run."""

    labels: np.ndarray  # (n,) int32, host-resident
    centroids: torch.Tensor  # (k, m)
    inertia: float
    iters: int
    rows_seen: int
    # The winner's trajectory: per-iteration inertia (last entry == inertia,
    # the final pass's cost under the final centroids) and centroid shifts.
    trajectory: list = dataclasses.field(default_factory=list)
    shifts: list = dataclasses.field(default_factory=list)


def ensure_embedding_cache(ctx: FitContext, *, devices=None) -> FitContext:
    """Fill the context's embed-once cache if it is empty; idempotent.

    Resident input (``ctx.array``) is embedded whole into the resident f32
    ``y_array``; blocked input takes one embedding pass over its blocks,
    staged to host memory as ``y_store`` under the policy's ``cache_dtype``,
    sharded across ``devices`` when more than one is given
    (`stream.sharded.stream_embed_sharded`).
    A call that finds the cache filled counts one ``backend.embed_cache_hits``.
    Returns ``ctx``."""
    from repro_torch import embed

    if (ctx.y_array if ctx.array is not None else ctx.y_store) is not None:
        obs.counter("backend.embed_cache_hits").inc()
    if ctx.array is not None:
        if ctx.y_array is None:
            ctx.y_array = embed.transform(ctx.params, ctx.array, ctx.policy)
    elif ctx.y_store is None:
        ctx.y_store = stream_embed(
            ctx.store, ctx.params, policy=ctx.policy, device=ctx.device,
            devices=devices if devices is not None and len(devices) > 1 else None)
    return ctx


def _run_restarts(ctx: FitContext, run_one) -> BackendFit:
    """Run every init (``run_one(init, r)``), keep the lowest-inertia fit
    (the first on a tie), total rows_seen over all restarts."""
    fits = [run_one(init, r) for r, init in enumerate(ctx.inits)]
    best = min(fits, key=lambda f: f.inertia)
    return dataclasses.replace(best, rows_seen=sum(f.rows_seen for f in fits))


def _from_stream(res) -> BackendFit:
    """StreamLloydResult -> BackendFit (shared by stream and minibatch)."""
    return BackendFit(
        labels=res.labels, centroids=res.centroids, inertia=res.inertia,
        iters=res.iters, rows_seen=res.rows_seen,
        trajectory=list(res.trajectory), shifts=list(res.shifts),
    )


@register_backend("local")
def fit_local(ctx: FitContext) -> BackendFit:
    """Single-program path: embed everything (or take the cached Y), Lloyd
    per restart."""
    from repro_torch import embed

    if ctx.y_array is not None:
        Y = ctx.y_array
    elif ctx.y_store is not None:
        Y = torch.from_numpy(ctx.y_store.materialize()).to(ctx.device)
    elif ctx.array is not None:
        Y = embed.transform(ctx.params, ctx.array, ctx.policy)
    else:
        X = torch.from_numpy(np.ascontiguousarray(ctx.store.materialize(), np.float32))
        Y = embed.transform(ctx.params, X.to(ctx.device), ctx.policy)
    n = int(Y.shape[0])

    def _run_one(init, r):
        res = lloyd(
            Y, ctx.k, discrepancy=ctx.params.discrepancy, iters=ctx.iters,
            init=init, policy=ctx.policy,
        )
        return BackendFit(
            labels=res.labels.cpu().numpy().astype(np.int32),
            centroids=res.centroids,
            inertia=float(res.inertia),
            iters=res.iters,
            rows_seen=(res.iters + 1) * n,
            trajectory=res.costs.tolist() + [float(res.inertia)],
            shifts=res.shifts.tolist(),
        )

    return _run_restarts(ctx, _run_one)


def _stream_source(ctx: FitContext) -> dict:
    """The stream drivers' data keywords: raw X blocks (embedding fused into
    the per-block step), or the staged Y cache when the context carries one."""
    if ctx.y_store is not None:
        obs.counter("backend.embed_cache_hits").inc()
        return dict(store=ctx.y_store, discrepancy=ctx.params.discrepancy)
    return dict(store=ctx.store, coeffs=ctx.params)


@register_backend("stream")
def fit_stream(ctx: FitContext) -> BackendFit:
    """Exact out-of-core Lloyd: the fixed point of ``local``, O(block) on the
    device."""
    return _run_restarts(ctx, lambda init, r: _from_stream(ooc_lloyd(
        k=ctx.k, iters=ctx.iters, init=init, policy=ctx.policy, device=ctx.device,
        checkpoint_dir=_restart_ckpt(ctx, r), **_stream_source(ctx),
    )))


@register_backend("stream_shard")
def fit_stream_shard(ctx: FitContext) -> BackendFit:
    """Exact out-of-core Lloyd sharded across the mesh's data devices (no
    mesh: every visible card, or [cpu] for a fit on the CPU): shard d
    streams ``store.shard(d, D)`` through its own producer, thread and
    stream; an iteration reduces the shards' (Z, g) once and updates the
    centroids once. The labels of ``stream`` from the same init, O(block) a
    shard. ``ctx.scheduler``: "lockstep" or "pool" (the fault-tolerant
    `repro_torch.pool` plane)."""
    from repro_torch.stream.sharded import shard_devices

    devices = shard_devices(ctx.mesh, device=ctx.device)
    return _run_restarts(ctx, lambda init, r: _from_stream(ooc_lloyd(
        k=ctx.k, iters=ctx.iters, init=init, policy=ctx.policy, devices=devices,
        scheduler=ctx.scheduler, checkpoint_dir=_restart_ckpt(ctx, r), **_stream_source(ctx),
    )))


@register_backend("shard_map")
def fit_shard_map(ctx: FitContext) -> BackendFit:
    """Algorithms 1 + 2 over the row shards of the resident X on the mesh
    (`core.distributed`), or on the fit's one device without a mesh. n must
    divide the mesh's data extent. The Lloyd loop runs the whole ``iters``
    budget; the inertia is the final centroids' assignment cost, summed over
    the shards on the host."""
    from repro_torch.core.distributed import distributed_embed, distributed_lloyd, shard_rows
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.device import on_device

    mesh = ctx.mesh if ctx.mesh is not None else make_mesh((1, 1), ("data", "model"),
                                                           devices=[ctx.device])
    if ctx.array is not None:
        X = ctx.array
    else:
        X = torch.from_numpy(np.ascontiguousarray(ctx.store.materialize(), np.float32))
    Xs = shard_rows(mesh, X)
    Y = distributed_embed(mesh, Xs, ctx.params, policy=ctx.policy)
    disc = ctx.params.discrepancy
    plan = ops.lloyd_step_plan(discrepancy=disc, policy=ctx.policy)
    n = int(X.shape[0])

    def _run_one(init, r):
        labels, centroids, costs = distributed_lloyd(
            mesh, Y, init, k=ctx.k, discrepancy=disc, iters=ctx.iters, policy=ctx.policy,
            return_costs=True,
        )
        inertia = 0.0
        for y in Y:
            with on_device(y.device):
                inertia += float(plan.assign(y, centroids.to(y.device))[1])
        return BackendFit(
            labels=labels.cpu().numpy().astype(np.int32), centroids=centroids,
            inertia=inertia, iters=ctx.iters, rows_seen=(ctx.iters + 1) * n,
            trajectory=costs.tolist() + [inertia],
        )

    return _run_restarts(ctx, _run_one)


@register_backend("minibatch")
def fit_minibatch(ctx: FitContext) -> BackendFit:
    """Single-pass streaming Lloyd with decayed (Z, g) sufficient stats
    (``decay`` and ``epochs`` apply)."""
    return _run_restarts(ctx, lambda init, r: _from_stream(minibatch_lloyd(
        k=ctx.k, decay=ctx.decay, epochs=ctx.epochs, init=init, policy=ctx.policy,
        device=ctx.device, checkpoint_dir=_restart_ckpt(ctx, r), **_stream_source(ctx),
    )))
