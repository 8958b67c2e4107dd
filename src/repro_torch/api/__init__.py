"""repro_torch.api: the estimator facade of the port.

    from repro_torch.api import KernelKMeans

    est = KernelKMeans(k=5, kernel="rbf", method="nystrom", l=128, m=64)
    est.fit(X)                 # on the card; device="cpu" for the plain path
    labels = est.predict(X_new)
    result = est.sweep(X, k_grid=[4, 5, 6], restarts=2)   # embed once, select k
    est.save("ckpt/")          # the ClusterModel, readable by the JAX package too
    est2 = KernelKMeans.load("ckpt/")
    est2.partial_fit(X_block)  # one decayed minibatch update from the loaded model
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
    resolve_kernel,
)
from repro_torch.api import backends as _backends  # noqa: F401,E402  (registers local)
from repro_torch.api.backends import (  # noqa: F401,E402
    BackendFit,
    FitContext,
    ensure_embedding_cache,
)
from repro_torch.api.estimator import AUTO_STREAM_ROWS, KernelKMeans  # noqa: F401,E402
from repro_torch.embed import Embedding  # noqa: F401,E402
from repro_torch.policy import ComputePolicy  # noqa: F401,E402
from repro_torch.sweep.result import SweepResult  # noqa: F401,E402
