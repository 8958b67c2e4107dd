"""ClusterModel: the one artifact a fit produces.

The fitted embedding params, the final centroids in embedding space, the
achieved inertia and static fit metadata. ``predict`` embeds unseen points
and assigns them to the nearest centroid, on the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.apnc import Discrepancy
from repro_torch.embed.base import EmbeddingParams


@dataclasses.dataclass(frozen=True)
class FitMeta:
    """Static provenance of a fit: everything needed to audit or rebuild the
    estimator that produced the model."""

    k: int = 0
    backend: str = "unknown"
    method: str = "unknown"
    kernel_name: str = ""
    iters: int = 0  # Lloyd iterations actually run (best restart)
    rows_seen: int = 0  # total rows visited during clustering
    n_init: int = 0  # restarts evaluated
    l: int = 0
    m: int = 0
    t: int | None = None
    q: int = 1
    iters_cap: int = 0
    decay: float = 0.9
    epochs: int = 1
    landmark_sample: int = 0
    seed_sample: int = 0
    block_rows: int = 0
    random_state: int = 0
    version: int = 1


@dataclasses.dataclass
class ClusterModel:
    """A fitted embed-and-conquer clustering: params + centroids + inertia + meta."""

    params: EmbeddingParams
    centroids: torch.Tensor  # (k, m) in embedding space
    inertia: torch.Tensor  # () sum of e(y_i, c_{pi(i)})
    meta: FitMeta = dataclasses.field(default_factory=FitMeta)

    # `report` (a repro_torch.obs.FitReport) is attached by the estimator as a
    # plain attribute, not a field: measurement, not model state, so neither
    # `to` nor a checkpoint carries it.
    report = None

    @property
    def coeffs(self) -> EmbeddingParams:
        """The JAX package's alias for ``params``, from when APNC coefficients
        were the only params."""
        return self.params

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def m(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def discrepancy(self) -> Discrepancy:
        return self.params.discrepancy

    def to(self, device) -> "ClusterModel":
        """The same model with its tensors on ``device``."""
        return dataclasses.replace(
            self, params=self.params.to(device),
            centroids=self.centroids.to(device), inertia=self.inertia.to(device),
        )

    def predict(self, X, *, policy=None, device=None) -> torch.Tensor:
        """Embed ``X`` (n, d) and assign each row to its nearest centroid
        (`repro_torch.core.kkmeans.predict`, the online path).

        Runs on ``device`` (default: the card; ``"cpu"`` for the plain path).
        Returns (n,) int64 labels on that device.
        """
        from repro_torch.core.kkmeans import predict as _predict

        return _predict(X, self.params, self.centroids, policy=policy, device=device)
