"""The legacy single-program drivers: fit an embedding, then cluster it (the
paper's two-phase pipeline), in the JAX package's call shape.

Thin shims over the estimator layer's pieces (`repro_torch.embed`,
`core.lloyd`): `KernelKMeans` owns backend dispatch and the `ClusterModel`
artifact; these keep the original call shape for existing call sites, with
an integer ``seed`` where the JAX package takes a PRNG key.

Not carried over from the JAX package: the deprecated ``use_pallas`` flag
(``APNCConfig.use_pallas``, ``predict(..., use_pallas)``) and a bare bool in
place of a policy. The port's `ComputePolicy` never had ``pallas``; its
kernel switch is ``ComputePolicy(kernels=...)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.apnc import assign
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.lloyd import LloydResult, lloyd
from repro_torch.device import resolve_device
from repro_torch.policy import ComputePolicy, as_policy

Method = str  # any registered embedding name (see repro_torch.embed)


@dataclasses.dataclass(frozen=True)
class APNCConfig:
    """Hyperparameters of the paper's experiments (Section 9); execution
    knobs live in ``policy`` (a ComputePolicy)."""

    method: Method = "nystrom"
    l: int = 300  # landmark sample size
    m: int = 200  # embedding dimensionality (per block)
    t: int | None = None  # APNC-SD subset size; default 0.4 * l
    q: int = 1  # number of R blocks (ensemble)
    iters: int = 20  # Lloyd cap; the paper fixes 20
    n_init: int = 4  # k-means++ restarts; lowest-inertia run wins
    policy: ComputePolicy | None = None

    @property
    def compute(self) -> ComputePolicy:
        """The effective execution policy."""
        return as_policy(self.policy)


def _as_tensor(X, device) -> torch.Tensor:
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    return X.to(device, torch.float32)


def fit_coefficients(seed: int, X: torch.Tensor, kernel: Kernel, cfg: APNCConfig):
    """Fit the configured member's params (any registered name, not just the
    original "nystrom" / "sd")."""
    from repro_torch.embed import get_embedding

    return get_embedding(cfg.method).fit(seed, X, kernel, l=cfg.l, m=cfg.m, t=cfg.t, q=cfg.q)


def apnc_embed(X: torch.Tensor, coeffs, policy: ComputePolicy | None = None) -> torch.Tensor:
    """Policy-routed embedding (shim over `repro_torch.embed.transform`: the
    member's kernel on the card, its plain version elsewhere)."""
    from repro_torch.embed import transform

    return transform(coeffs, X, as_policy(policy))


def fit_predict(seed: int, X, kernel: Kernel, k: int, cfg: APNCConfig | None = None, *,
                device=None) -> tuple[LloydResult, object]:
    """Embed-and-conquer: fit the embedding on X, embed it, run ``n_init``
    k-means++ restarts of Lloyd, keep the lowest inertia (the first on a
    tie). Returns the winning `LloydResult` and the params, so that new
    points can be embedded and assigned online (`predict`).

    The seed splits as the estimator's does: the fit takes ``phase1_seeds``'
    fit seed, restart r draws its k-means++ from
    ``restart_generator(seed_seed, r)``. Runs on ``device`` (default: the
    card; ``"cpu"`` for the plain path)."""
    from repro_torch.api.estimator import phase1_seeds, restart_generator

    cfg = cfg or APNCConfig()
    X = _as_tensor(X, resolve_device(device))
    _, s_fit, s_seed = phase1_seeds(seed)
    coeffs = fit_coefficients(s_fit, X, kernel, cfg)
    Y = apnc_embed(X, coeffs, cfg.compute)
    best = None
    for r in range(max(1, cfg.n_init)):  # restarts: kernel k-means is init-sensitive
        res = lloyd(Y, k, discrepancy=coeffs.discrepancy, iters=cfg.iters,
                    generator=restart_generator(s_seed, r), policy=cfg.compute)
        if best is None or float(res.inertia) < float(best.inertia):
            best = res
    return best, coeffs


def predict(X, coeffs, centroids: torch.Tensor, *, policy: ComputePolicy | None = None,
            device=None) -> torch.Tensor:
    """Assign unseen points: embed, then the nearest centroid under e — the
    online path a serving system uses (Property 4.4). Runs on ``device``
    (default: the card); returns (n,) int64 labels there."""
    dev = resolve_device(device)
    Y = apnc_embed(_as_tensor(X, dev), coeffs.to(dev), policy)
    return assign(Y, centroids.to(dev), coeffs.discrepancy)
