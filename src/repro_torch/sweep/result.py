"""SweepResult: the one artifact a multi-candidate sweep produces.

A sweep evaluates R restarts x a k-grid of clusterings over one embedding.
Its result is the candidate lattice, a `ClusterModel` per (k, restart), plus
the inertia table the selection reads, with a deterministic rule:

    best = argmin inertia, ties broken toward the earlier k-grid entry and
    then the lower restart index (the flattened k-major argmin's first hit).

Restarts that converge to the same fixed point give bit-equal inertias, so
selection must not depend on dict order or float noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.model import ClusterModel


@dataclasses.dataclass
class SweepResult:
    """All candidate models of one embed-once sweep, plus the selection."""

    #: models[k_index][restart]: every candidate, sharing one set of params.
    models: list[list[ClusterModel]]
    #: (len(k_grid), restarts) achieved inertia per candidate.
    inertia: np.ndarray
    #: labels[k_index][restart]: (n,) int32 host labels per candidate, or None.
    labels: list[list[np.ndarray]] | None
    k_grid: tuple[int, ...] = ()
    restarts: int = 1
    #: the backend that ran the candidate Lloyd iterations
    backend: str = ""
    best_k_index: int = 0
    best_restart: int = 0
    #: whether the sweep resumed from a persisted embed stage instead of
    #: running phase 1 and the embedding pass
    resumed: bool = False

    @staticmethod
    def select_best(inertia: np.ndarray) -> tuple[int, int]:
        """Deterministic argmin over the (k_index, restart) lattice: exact
        float comparison, the first hit in k-major order wins ties."""
        table = np.asarray(inertia)
        flat = int(np.argmin(table))
        return flat // table.shape[1], flat % table.shape[1]

    @property
    def best(self) -> ClusterModel:
        """The selected model (lowest inertia, deterministic tie-break)."""
        return self.models[self.best_k_index][self.best_restart]

    @property
    def best_k(self) -> int:
        return self.k_grid[self.best_k_index]

    @property
    def best_inertia(self) -> float:
        return float(self.inertia[self.best_k_index, self.best_restart])

    @property
    def best_labels(self) -> np.ndarray | None:
        if self.labels is None:
            return None
        return self.labels[self.best_k_index][self.best_restart]

    def candidates(self):
        """Iterate (k, restart, ClusterModel, inertia) in selection order."""
        for i, k in enumerate(self.k_grid):
            for r in range(self.restarts):
                yield k, r, self.models[i][r], float(self.inertia[i, r])

    def inertia_table(self) -> dict[int, list[float]]:
        """{k: [inertia per restart]}: the model-selection view."""
        return {k: [float(v) for v in self.inertia[i]] for i, k in enumerate(self.k_grid)}
