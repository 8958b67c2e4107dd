"""`KernelKMeans`: the estimator of the port, on the ``local`` backend.

Phase 1 runs here: a reservoir sample over the blocked host view of the data
selects landmarks, the embedding member fits its params on the sample, the
seeding pool is embedded, and k-means++ seeds one init per restart. Phase 2
(Lloyd) runs in the backend. Everything runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.api.backends import FitContext
from repro_torch.api.model import ClusterModel, FitMeta
from repro_torch.api.registry import get_backend, get_embedding, resolve_kernel
from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
from repro_torch.core.lloyd import block_cost, kmeanspp_init
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.reservoir import reservoir_sample


def phase1_seeds(seed: int) -> tuple[int, int, int]:
    """The canonical phase-1 split of one root seed into three independent
    integer seeds, (sample, fit, seed): which rows the reservoir keeps, the
    embedding fit's draws, and the k-means++ seeding."""
    children = np.random.SeedSequence(int(seed)).spawn(3)
    s_sample, s_fit, s_seed = (int(c.generate_state(1)[0]) for c in children)
    return s_sample, s_fit, s_seed


def restart_generator(seed_seed: int, r: int) -> torch.Generator:
    """The CPU generator of restart r's k-means++ draws."""
    state = np.random.SeedSequence(int(seed_seed), spawn_key=(r,)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _as_tensor(X) -> torch.Tensor:
    if isinstance(X, torch.Tensor):
        return X
    return torch.from_numpy(np.ascontiguousarray(X, np.float32))


class KernelKMeans:
    """Kernel k-means via explicit embeddings (the paper's embed-and-conquer).

    k:               number of clusters.
    kernel:          registered kernel name or a `Kernel`. With kernel="rbf" and
                     no kernel_params, gamma is self-tuned on the landmark sample.
    method:          registered embedding member: "nystrom" (l2) or "sd" (l1).
    backend:         "local" (the one backend of this slice) or "auto".
    l, m, t, q:      landmark count, embedding dim per block, SD subset size,
                     ensemble blocks, as in the paper.
    iters, n_init:   Lloyd cap and k-means++ restarts (best inertia wins).
    block_rows:      blocking of the host view the reservoir reads.
    landmark_sample: reservoir size for the embedding fit.
    seed_sample:     rows of the landmark sample used for k-means++ seeding.
    policy:          `ComputePolicy`.
    random_state:    root seed when fit() is not given one.
    device:          where the fit runs: None (the card) or e.g. "cpu".

    After fit: `model_`, `labels_`, `inertia_`, `n_iter_`, `kernel_`,
    `backend_`, and `phases_` (wall seconds per phase).
    """

    def __init__(
        self,
        k: int,
        *,
        kernel: str | Kernel = "rbf",
        kernel_params: dict | None = None,
        method: str = "nystrom",
        backend: str = "auto",
        l: int = 300,
        m: int = 200,
        t: int | None = None,
        q: int = 1,
        iters: int = 20,
        n_init: int = 1,
        block_rows: int = 4096,
        landmark_sample: int = 4096,
        seed_sample: int = 1024,
        policy: ComputePolicy | None = None,
        random_state: int = 0,
        device=None,
    ):
        self.k = int(k)
        self.kernel = kernel
        self.kernel_params = dict(kernel_params or {})
        self.method = method
        self.backend = backend
        self.l, self.m, self.t, self.q = l, m, t, q
        self.iters, self.n_init = iters, n_init
        self.block_rows = block_rows
        self.landmark_sample = landmark_sample
        self.seed_sample = seed_sample
        self.policy = policy if policy is not None else ComputePolicy()
        self.random_state = random_state
        self.device = device

        self.model_: ClusterModel | None = None
        self.labels_: np.ndarray | None = None
        self.inertia_: float | None = None
        self.n_iter_: int | None = None
        self.kernel_: Kernel | None = None
        self.backend_: str | None = None
        self.phases_: dict[str, float] = {}

    # ------------------------------------------------------------- dispatch

    def _choose_backend(self) -> str:
        return "local" if self.backend == "auto" else self.backend

    def _resolve_kernel(self, sample: torch.Tensor) -> Kernel:
        if not isinstance(self.kernel, Kernel) and self.kernel == "rbf" \
                and not self.kernel_params:
            return self_tuned_rbf(sample, seed=self.random_state)
        return resolve_kernel(self.kernel, self.kernel_params)

    @contextmanager
    def _phase(self, name: str, dev: torch.device):
        """Wall time of one phase, synchronised with the card at both ends."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.phases_[name] = self.phases_.get(name, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------ lifecycle

    def _prepare(self, X, seed: int, dev: torch.device) -> FitContext:
        """Phase 1: blocked host view, reservoir sample, embedding fit,
        seeding pool, k-means++ inits."""
        self.phases_ = {}
        with self._phase("host_view", dev):
            if isinstance(X, BlockStore):
                store = X
                array = torch.from_numpy(np.ascontiguousarray(X.materialize(), np.float32))
            else:
                array = _as_tensor(X)
                # The host copy is deliberate: sampling through the same
                # blocking on every backend keeps phase 1 identical across them.
                store = BlockStore.from_array(
                    array.detach().to("cpu", torch.float32).numpy(), self.block_rows
                )
            array = array.to(dev, torch.float32)
        s_sample, s_fit, s_seed = phase1_seeds(seed)
        with self._phase("reservoir", dev):
            sample = torch.from_numpy(
                reservoir_sample(store, self.landmark_sample, seed=s_sample)
            ).to(dev)
        with self._phase("embed_fit", dev):
            self.kernel_ = self._resolve_kernel(sample)
            params = get_embedding(self.method).fit(
                s_fit, sample, self.kernel_, l=self.l, m=self.m, t=self.t, q=self.q
            )
            pool = ops.embed_block_map(sample[: self.seed_sample], params, policy=self.policy)
        with self._phase("seed", dev):
            inits = [
                kmeanspp_init(restart_generator(s_seed, r), pool, self.k, params.discrepancy)
                for r in range(max(1, self.n_init))
            ]
        return FitContext(
            store=store, array=array, params=params, k=self.k, inits=inits,
            iters=self.iters, policy=self.policy,
        )

    def fit(self, X, y=None, *, seed: int | None = None) -> "KernelKMeans":
        """Fit on an (n, d) array (numpy or torch) or a BlockStore.

        Args:
            X: the data.
            y: ignored (sklearn signature compatibility).
            seed: root seed; ``None`` uses ``random_state``.

        Returns:
            self, fitted.
        """
        dev = resolve_device(self.device)
        name = self._choose_backend()
        backend = get_backend(name)
        get_embedding(self.method)
        ctx = self._prepare(X, self.random_state if seed is None else seed, dev)
        with self._phase("lloyd", dev):
            out = backend(ctx)
        meta = self._fit_meta(
            backend=name, iters=int(out.iters), rows_seen=int(out.rows_seen),
            n_init=max(1, self.n_init),
        )
        self.model_ = ClusterModel(
            params=ctx.params, centroids=out.centroids,
            inertia=torch.tensor(out.inertia, dtype=torch.float32), meta=meta,
        )
        self.labels_ = out.labels
        self.inertia_ = float(out.inertia)
        self.n_iter_ = int(out.iters)
        self.backend_ = name
        return self

    def fit_predict(self, X, *, seed: int | None = None) -> np.ndarray:
        """``fit(X, seed=seed).labels_``."""
        return self.fit(X, seed=seed).labels_

    def _fit_meta(self, **kw) -> FitMeta:
        return FitMeta(
            k=self.k, method=self.method,
            kernel_name=getattr(self.kernel_, "name", ""),
            l=self.l, m=self.m, t=self.t, q=self.q, iters_cap=self.iters,
            landmark_sample=self.landmark_sample, seed_sample=self.seed_sample,
            block_rows=self.block_rows, random_state=self.random_state, **kw,
        )

    # ------------------------------------------------------------ inference

    def _require_model(self) -> ClusterModel:
        if self.model_ is None:
            raise RuntimeError("estimator is not fitted; call fit()")
        return self.model_

    def predict(self, X) -> np.ndarray:
        """Nearest-centroid labels of unseen rows, (n,) int32 on the host."""
        labels = self._require_model().predict(X, policy=self.policy, device=self.device)
        return labels.cpu().numpy().astype(np.int32)

    def transform(self, X) -> torch.Tensor:
        """The fitted embedding Y = f(X), (n, m) f32 on the fit's device."""
        from repro_torch import embed

        dev = resolve_device(self.device)
        model = self._require_model().to(dev)
        return embed.transform(model.params, _as_tensor(X).to(dev, torch.float32), self.policy)

    def score(self, X) -> float:
        """Negative inertia of X under the fitted centroids (higher is better)."""
        model = self._require_model().to(resolve_device(self.device))
        Y = self.transform(X)
        return -float(block_cost(Y, model.centroids, model.discrepancy))
