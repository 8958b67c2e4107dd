"""The sweep orchestrator: embed once, cluster the whole candidate lattice.

`KernelKMeans.fit` pays the embedding (the dominant cost) on every Lloyd
pass of every candidate; model selection over R restarts x a k-grid would
pay it R * |k_grid| * (iters + 1) times. `sweep_estimator` restructures that:

  phase 1  exactly `fit`'s phase 1 (the same seed split, reservoir sample,
           member fit and seeding pool), so candidate (k, r) seeds from the
           k-means++ draw `fit` uses for its restart r;
  phase 2  one embedding pass: resident input into a resident f32 Y, blocked
           input staged to host blocks under the policy's `cache_dtype`;
  phase 3  multi-candidate Lloyd over the cache (`repro_torch.sweep.engine`):
           every engine pass feeds every still-active candidate;
  phase 4  deterministic best-model selection (`SweepResult.select_best`),
           which the estimator adopts.

Keystone: `sweep(k_grid=[k], restarts=1)` reaches the labels of `fit(k)` from
the same seed, for every registered embedding member, on the local and
stream backends.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.backends import FitContext, ensure_embedding_cache
from repro_torch.api.model import ClusterModel
from repro_torch.core.lloyd import kmeanspp_init
from repro_torch.device import resolve_device
from repro_torch.sweep.engine import (
    SweepLloydOut,
    sweep_lloyd,
    sweep_lloyd_local,
    sweep_lloyd_sharded,
)
from repro_torch.sweep.result import SweepResult

#: Backends a sweep can amortize one embedding across; minibatch's decayed
#: trajectory has no embed-once counterpart, so `fit` stays its entry point.
#: "stream_shard" raises until the sharded stream is ported.
SWEEP_BACKENDS = ("local", "stream", "stream_shard")


def run_sweep(ctx: FitContext, k_grid: tuple[int, ...], inits: list, *, backend: str,
              devices=None) -> SweepLloydOut:
    """Dispatch the multi-candidate engine for one prepared context whose
    embed cache is filled (`ensure_embedding_cache`)."""
    disc = ctx.params.discrepancy
    if backend == "local":
        return sweep_lloyd_local(ctx.y_array, inits, disc, iters=ctx.iters, policy=ctx.policy)
    if backend == "stream":
        return sweep_lloyd(ctx.y_store, inits, disc, iters=ctx.iters, policy=ctx.policy,
                           device=ctx.device)
    if backend == "stream_shard":
        return sweep_lloyd_sharded(ctx.y_store, inits, disc, devices=devices)
    raise ValueError(
        f"backend {backend!r} cannot run an embed-once sweep; supported: {SWEEP_BACKENDS}"
    )


def sweep_estimator(est, X, k_grid, *, restarts: int | None = None, seed: int | None = None,
                    checkpoint_dir=None) -> SweepResult:
    """The engine behind `KernelKMeans.sweep` (``est`` is the estimator)."""
    k_grid = tuple(int(k) for k in k_grid)
    if not k_grid:
        raise ValueError("k_grid must name at least one candidate k")
    if any(k < 1 for k in k_grid):
        raise ValueError(f"every k in k_grid must be >= 1, got {k_grid}")
    R = int(restarts) if restarts is not None else max(1, est.n_init)
    if R < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir= (the persisted embed-once stage and sweep result) is "
            "not ported yet; it arrives with the checkpoints (ROADMAP.md, Queue 1 item 10)"
        )
    backend = est._choose_backend(X)
    if backend == "stream_shard":
        raise NotImplementedError(
            "backend 'stream_shard' is not ported yet; it arrives with the sharded "
            "stream (ROADMAP.md, Queue 1 item 13)"
        )
    if backend not in SWEEP_BACKENDS:
        raise ValueError(
            f"backend {backend!r} cannot run an embed-once sweep; supported: {SWEEP_BACKENDS}"
        )
    from repro_torch.api.registry import get_embedding

    get_embedding(est.method)  # reject typos before streaming any data
    dev = resolve_device(est.device)
    seed = est.random_state if seed is None else seed

    # Phase 1, identical to fit()'s: the same seed split feeds the same
    # reservoir, member fit and seeding pool.
    store, array, params, pool, s_seed = est._phase1(X, seed, dev, backend)
    ctx = FitContext(
        store=store, array=array, params=params, k=k_grid[0], inits=[], iters=est.iters,
        policy=est.policy, device=dev, decay=est.decay, epochs=est.epochs,
    )
    with est._phase("embed_cache", dev):
        ensure_embedding_cache(ctx)
        if backend == "local" and ctx.y_array is None:
            # local over a BlockStore: the resident driver takes the decoded
            # staged blocks as one array.
            ctx.y_array = torch.from_numpy(ctx.y_store.materialize()).to(dev)
    # Restart r of every k seeds from restart_generator(s_seed, r): the draw
    # fit() uses for its restart r.
    with est._phase("seed", dev):
        inits = [torch.stack(est._seed_inits(pool, s_seed, k, params.discrepancy, R))
                 for k in k_grid]
    with est._phase("lloyd", dev):
        out = run_sweep(ctx, k_grid, inits, backend=backend)

    n = ctx.y_store.n if ctx.y_store is not None else int(ctx.y_array.shape[0])
    models = []
    for i, k in enumerate(k_grid):
        row = []
        for r in range(R):
            iters_r = int(out.iters[i, r])
            meta = dataclasses.replace(
                est._fit_meta(backend=backend, iters=iters_r, rows_seen=(iters_r + 1) * n,
                              n_init=R),
                k=k,
            )
            row.append(ClusterModel(
                params=params, centroids=out.centroids[i][r],
                inertia=torch.tensor(out.inertia[i, r], dtype=torch.float32), meta=meta,
            ))
        models.append(row)

    best_i, best_r = SweepResult.select_best(out.inertia)
    result = SweepResult(
        models=models, inertia=np.asarray(out.inertia), labels=out.labels, k_grid=k_grid,
        restarts=R, backend=backend, best_k_index=best_i, best_restart=best_r,
    )
    # The estimator adopts the selected model: predict / transform / score
    # serve the sweep's best as if fit() had produced it.
    est.model_ = result.best
    est.labels_ = result.best_labels
    est.inertia_ = result.best_inertia
    est.n_iter_ = int(out.iters[best_i, best_r])
    est.backend_ = backend
    return result
