"""Execution backends behind `KernelKMeans`.

Each backend receives the same prepared inputs (a FitContext) and returns the
same result shape (a BackendFit). This slice registers the ``local`` backend:
embed everything, then Lloyd per restart over the resident Y. The stream
backends arrive in a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.registry import register_backend
from repro_torch.core.lloyd import lloyd
from repro_torch.embed.base import EmbeddingParams
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore


@dataclasses.dataclass
class FitContext:
    """Everything a clustering backend needs, prepared once by the estimator."""

    store: BlockStore  # blocked host view of the data (always present)
    array: torch.Tensor  # the resident array on the fit's device
    params: EmbeddingParams  # fitted params of the registered embedding member
    k: int
    inits: list[torch.Tensor]  # k-means++ init centroids, one per restart
    iters: int
    policy: ComputePolicy


@dataclasses.dataclass
class BackendFit:
    """Uniform raw result of one backend run."""

    labels: np.ndarray  # (n,) int32, host-resident
    centroids: torch.Tensor  # (k, m)
    inertia: float
    iters: int
    rows_seen: int


def _run_restarts(ctx: FitContext, run_one) -> BackendFit:
    """Run every init, keep the lowest-inertia fit (the first on a tie),
    total rows_seen over all restarts."""
    fits = [run_one(init, r) for r, init in enumerate(ctx.inits)]
    best = min(fits, key=lambda f: f.inertia)
    return dataclasses.replace(best, rows_seen=sum(f.rows_seen for f in fits))


@register_backend("local")
def fit_local(ctx: FitContext) -> BackendFit:
    """Single-program path: embed everything, Lloyd per restart."""
    from repro_torch import embed

    Y = embed.transform(ctx.params, ctx.array, ctx.policy)
    n = int(Y.shape[0])

    def _run_one(init, r):
        res = lloyd(
            Y, ctx.k, discrepancy=ctx.params.discrepancy, iters=ctx.iters,
            init=init,
        )
        return BackendFit(
            labels=res.labels.cpu().numpy().astype(np.int32),
            centroids=res.centroids,
            inertia=float(res.inertia),
            iters=res.iters,
            rows_seen=(res.iters + 1) * n,
        )

    return _run_restarts(ctx, _run_one)
