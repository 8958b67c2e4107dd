"""Data-pipeline use of the paper's technique: kernelized corpus clustering
for curation and grouping.

`cluster_corpus` embeds document feature vectors with a registered embedding
member and clusters them with the MapReduce programs of `core.distributed`
over a device mesh, through the public `KernelKMeans` facade
(``backend="shard_map"``), so it takes any registered embedding or kernel
name and produces the canonical `ClusterModel` artifact.
"""
from __future__ import annotations

from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import Kernel


def cluster_corpus(mesh, X, k: int, *, method: str = "sd", l: int = 256, m: int = 256,
                   kernel: Kernel | str | None = None, seed: int = 0, iters: int = 20):
    """X: (n_docs, d_features) array (numpy or torch); n must divide the
    mesh's data extent. Returns (labels, centroids, params): host int32
    labels, the centroids on the mesh's first data device, and the fitted
    params for online assignment of new documents (`core.kkmeans.predict`).
    ``kernel=None`` is the self-tuned rbf."""
    est = KernelKMeans(
        k, kernel=kernel if kernel is not None else "rbf", method=method,
        backend="shard_map", l=l, m=m, iters=iters, mesh=mesh, random_state=seed,
    )
    est.fit(X)
    return est.labels_, est.model_.centroids, est.model_.params
