"""repro_torch.sweep: embed-once model selection over restarts and k.

The embedding is the dominant cost of a fit, and the paper's two-phase split
(embed once, then cheap linear k-means) makes restarts and k-selection nearly
free if the embedding is computed once. This package is that layer:

  * `repro_torch.sweep.engine`: multi-candidate Lloyd drivers over a cached
    embedding (single-device stream, resident local);
  * `repro_torch.sweep.result`: `SweepResult`, the candidate lattice of
    `ClusterModel`s, the inertia table and the deterministic best-model
    selection;
  * `repro_torch.sweep.orchestrator`: the glue behind `KernelKMeans.sweep`.

    est = KernelKMeans(8, method="nystrom", backend="stream",
                       policy=ComputePolicy(cache_dtype="int8"))
    result = est.sweep(store, k_grid=[4, 8], restarts=2)
    result.inertia_table()   # {k: [inertia per restart]}
    result.best              # lowest-inertia ClusterModel, deterministic ties
"""
from repro_torch.sweep.engine import (
    SweepLloydOut,
    sweep_lloyd,
    sweep_lloyd_local,
    sweep_lloyd_sharded,
)
from repro_torch.sweep.orchestrator import SWEEP_BACKENDS, run_sweep, sweep_estimator
from repro_torch.sweep.result import SweepResult

__all__ = [
    "SWEEP_BACKENDS",
    "SweepLloydOut",
    "SweepResult",
    "run_sweep",
    "sweep_estimator",
    "sweep_lloyd",
    "sweep_lloyd_local",
    "sweep_lloyd_sharded",
]
