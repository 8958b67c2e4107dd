"""repro_torch.api: the estimator facade of the port.

    from repro_torch.api import KernelKMeans

    est = KernelKMeans(k=5, kernel="rbf", method="nystrom", l=128, m=64)
    est.fit(X)                 # on the card; device="cpu" for the plain path
    labels = est.predict(X_new)
    result = est.sweep(X, k_grid=[4, 5, 6], restarts=2)   # embed once, select k
    est.save("ckpt/")          # the ClusterModel, readable by the JAX package too
    est2 = KernelKMeans.load("ckpt/")
    est2.partial_fit(X_block)  # one decayed minibatch update from the loaded model

Extend by registering, not by editing: `register_backend`, `register_kernel`,
`register_embedding` (the nystrom, sd, rff and tensorsketch members ship
registered). The serving surface (`ModelRegistry`, `ServingTier`, `Shed`)
is re-exported lazily from `repro_torch.serving`, which imports this module.
"""
from repro_torch.api.model import ClusterModel, FitMeta  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    BACKENDS,
    EMBEDDINGS,
    KERNELS,
    available_backends,
    available_embeddings,
    get_backend,
    get_embedding,
    register_backend,
    register_embedding,
    register_kernel,
    register_method,
    resolve_kernel,
    unregister_embedding,
)
from repro_torch.api import backends as _backends  # noqa: F401,E402  (registers local)
from repro_torch.api.backends import (  # noqa: F401,E402
    BackendFit,
    FitContext,
    ensure_embedding_cache,
)
from repro_torch.api.estimator import AUTO_STREAM_ROWS, KernelKMeans  # noqa: F401,E402
from repro_torch.embed import Embedding, EmbeddingProps  # noqa: F401,E402
from repro_torch.policy import ComputePolicy  # noqa: F401,E402
from repro_torch.sweep.result import SweepResult  # noqa: F401,E402


def __getattr__(name):
    # The serving surface lives in repro_torch.serving, which imports this
    # package for the ClusterModel artifact; a lazy re-export avoids the
    # import cycle while `from repro_torch.api import ModelRegistry` works.
    if name in ("ModelRegistry", "ServingTier", "Shed"):
        import repro_torch.serving as _serving

        return getattr(_serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AUTO_STREAM_ROWS",
    "BACKENDS",
    "BackendFit",
    "ClusterModel",
    "ComputePolicy",
    "EMBEDDINGS",
    "Embedding",
    "EmbeddingProps",
    "FitContext",
    "FitMeta",
    "KERNELS",
    "KernelKMeans",
    "ModelRegistry",
    "ServingTier",
    "Shed",
    "SweepResult",
    "available_backends",
    "ensure_embedding_cache",
    "available_embeddings",
    "get_backend",
    "get_embedding",
    "register_backend",
    "register_embedding",
    "register_kernel",
    "register_method",
    "resolve_kernel",
    "unregister_embedding",
]
