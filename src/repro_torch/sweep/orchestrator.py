"""The sweep orchestrator: embed once, cluster the whole candidate lattice.

`KernelKMeans.fit` pays the embedding (the dominant cost) on every Lloyd
pass of every candidate; model selection over R restarts x a k-grid would
pay it R * |k_grid| * (iters + 1) times. `sweep_estimator` restructures that:

  phase 1  exactly `fit`'s phase 1 (the same seed split, reservoir sample,
           member fit and seeding pool), so candidate (k, r) seeds from the
           k-means++ draw `fit` uses for its restart r;
  phase 2  one embedding pass: resident input into a resident f32 Y, blocked
           input staged to host blocks under the policy's `cache_dtype`;
           with a ``checkpoint_dir``, persisted by `repro_torch.sweep.stage`
           so that an interrupted sweep resumes past phases 1 and 2;
  phase 3  multi-candidate Lloyd over the cache (`repro_torch.sweep.engine`):
           every engine pass feeds every still-active candidate;
  phase 4  deterministic best-model selection (`SweepResult.select_best`),
           which the estimator adopts, and with a ``checkpoint_dir`` the
           `SweepResult` persisted.

Keystone: `sweep(k_grid=[k], restarts=1)` reaches the labels of `fit(k)` from
the same seed, for every registered embedding member, on the local and
stream backends. On ``stream_shard`` the embedding pass and the Lloyd passes
are sharded across the mesh's data devices (`sweep_lloyd_sharded`).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.backends import FitContext, ensure_embedding_cache
from repro_torch.api.model import ClusterModel
from repro_torch.stream.blockstore import BlockStore
from repro_torch.sweep.engine import (
    SweepLloydOut,
    sweep_lloyd,
    sweep_lloyd_local,
    sweep_lloyd_sharded,
)
from repro_torch.sweep.result import SweepResult
from repro_torch.sweep.stage import load_embed_stage, save_embed_stage

#: Backends a sweep can amortize one embedding across; minibatch's decayed
#: trajectory and shard_map's resident-mesh layout have no embed-once
#: counterpart, so `fit` stays their entry point.
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
        return sweep_lloyd_sharded(ctx.y_store, inits, disc, iters=ctx.iters,
                                   policy=ctx.policy, devices=devices)
    raise ValueError(
        f"backend {backend!r} cannot run an embed-once sweep; supported: {SWEEP_BACKENDS}"
    )


def sweep_estimator(est, X, k_grid, *, restarts: int | None = None, seed: int | None = None,
                    checkpoint_dir: str | Path | None = None) -> SweepResult:
    """The engine behind `KernelKMeans.sweep` (``est`` is the estimator)."""
    k_grid = tuple(int(k) for k in k_grid)
    if not k_grid:
        raise ValueError("k_grid must name at least one candidate k")
    if any(k < 1 for k in k_grid):
        raise ValueError(f"every k in k_grid must be >= 1, got {k_grid}")
    R = int(restarts) if restarts is not None else max(1, est.n_init)
    if R < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    backend = est._choose_backend(X)
    if backend not in SWEEP_BACKENDS:
        raise ValueError(
            f"backend {backend!r} cannot run an embed-once sweep; supported: {SWEEP_BACKENDS}"
        )
    from repro_torch.api.registry import get_embedding

    get_embedding(est.method)  # reject typos before streaming any data
    dev = est._device()
    devices = None
    if backend == "stream_shard":
        from repro_torch.stream.sharded import shard_devices

        devices = shard_devices(est.mesh, device=dev)
    seed = est.random_state if seed is None else seed
    input_shape = (X.n, X.d) if isinstance(X, BlockStore) else tuple(int(v) for v in X.shape)

    metrics_before = obs.snapshot("engine.")
    est.phases_ = {}
    stage = None
    if checkpoint_dir is not None:
        with est._phase("stage_load", dev), obs.span("sweep.stage_load", cat="sweep"):
            stage = load_embed_stage(checkpoint_dir, method=est.method, sweep_seed=seed,
                                     input_shape=input_shape,
                                     cache_dtype=est.policy.cache_dtype, device=dev)
    if stage is not None:
        params, pool, s_seed, y_store = stage
        est.kernel_ = getattr(params, "kernel", None) or est.kernel_
        ctx = FitContext(
            store=y_store, array=None, params=params, k=k_grid[0], inits=[],
            iters=est.iters, policy=est.policy, device=dev, decay=est.decay,
            epochs=est.epochs, y_store=y_store, mesh=est.mesh, scheduler=est.scheduler,
        )
        if backend == "local":
            ctx.y_store = None
            ctx.y_array = torch.from_numpy(y_store.materialize()).to(dev)
    else:
        # Phase 1, identical to fit()'s: the same seed split feeds the same
        # reservoir, member fit and seeding pool.
        store, array, params, pool, s_seed = est._phase1(X, seed, dev, backend)
        ctx = FitContext(
            store=store, array=array, params=params, k=k_grid[0], inits=[],
            iters=est.iters, policy=est.policy, device=dev, decay=est.decay,
            epochs=est.epochs, mesh=est.mesh, scheduler=est.scheduler,
        )
        with est._phase("embed_cache", dev):
            ensure_embedding_cache(ctx, devices=devices)
            if backend == "local" and ctx.y_array is None:
                # local over a BlockStore: the resident driver takes the
                # decoded staged blocks as one array.
                ctx.y_array = torch.from_numpy(ctx.y_store.materialize()).to(dev)
        if checkpoint_dir is not None:
            with est._phase("stage_save", dev), obs.span("sweep.stage_save", cat="sweep"):
                save_embed_stage(
                    checkpoint_dir, params=params, pool=pool, s_seed=s_seed,
                    y_store=ctx.y_store or _staged(ctx.y_array, est),
                    sweep_seed=seed, method=est.method, input_shape=input_shape,
                )
    # Restart r of every k seeds from restart_generator(s_seed, r): the draw
    # fit() uses for its restart r.
    with est._phase("seed", dev):
        inits = [torch.stack(est._seed_inits(pool, s_seed, k, params.discrepancy, R,
                                             est.policy))
                 for k in k_grid]
    with est._phase("lloyd", dev), obs.span("sweep.lloyd", cat="sweep", backend=backend,
                                            candidates=len(k_grid) * R):
        out = run_sweep(ctx, k_grid, inits, backend=backend, devices=devices)

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
        resumed=stage is not None,
    )
    if checkpoint_dir is not None:
        from repro_torch.distributed.checkpoint import save_sweep_result

        with est._phase("result_save", dev):
            save_sweep_result(checkpoint_dir, result)
    # The estimator adopts the selected model: predict / transform / score /
    # save serve the sweep's best as if fit() had produced it.
    est.model_ = result.best
    est.labels_ = result.best_labels
    est.inertia_ = result.best_inertia
    est.n_iter_ = int(out.iters[best_i, best_r])
    est.backend_ = backend
    est._pf_state = None
    # The sweep's one FitReport (phases with the embed-once pass, passes and
    # bytes of the whole sweep, the candidate accounting), on the result, the
    # estimator and the best model. The engine keeps no per-iteration costs
    # of the candidates, so the trajectory is the winner's final inertia.
    result.report = est._attach_report(
        backend, metrics_before, trajectory=[result.best_inertia], iters=est.n_iter_,
        rows_seen=result.best.meta.rows_seen,
        extra=dict(sweep=True, k_grid=list(k_grid), restarts=R, resumed=result.resumed,
                   candidates=len(k_grid) * R, best_k=int(k_grid[best_i]),
                   best_restart=int(best_r), lloyd_passes=int(out.passes)),
    )
    return result


def _staged(y_array: torch.Tensor, est) -> BlockStore:
    """The local backend's resident Y as a host store under the policy's
    codec, so that the stage's fingerprint is the one a resume asks for."""
    y_np = y_array.cpu().numpy()
    y_store = BlockStore.empty(n=y_np.shape[0], d=y_np.shape[1], block_rows=est.block_rows,
                               codec=est.policy.cache_dtype)
    for b in range(y_store.num_blocks):
        y_store.put(b, y_np[b * est.block_rows:(b + 1) * est.block_rows])
    return y_store
