"""`KernelKMeans`: the estimator of the port, on the ``local``, ``stream``
and ``minibatch`` backends, and its embed-once ``sweep``.

Phase 1 runs here, identically for every backend: a reservoir sample over the
blocked host view of the data selects landmarks, the embedding member fits
its params on the sample, the seeding pool is embedded, and k-means++ seeds
one init per restart. Phase 2 (Lloyd) runs in the backend, so ``local`` and
``stream`` reach the same fixed point from the same init. Everything runs on
the card unless the caller passes ``device="cpu"``; the streaming backends
keep O(block) of the data on it.
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

#: backend="auto": in-memory arrays of at least this many rows are clustered
#: out-of-core (through a BlockStore) instead of being embedded whole on the
#: device.
AUTO_STREAM_ROWS = 2_000_000


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
    method:          registered embedding member: "nystrom" (l2), "sd" (l1) or
                     "rff" (random Fourier features, rbf kernels).
    backend:         "local" | "stream" | "minibatch" | "auto". auto ->
                     "stream" for a BlockStore input or an array of at least
                     AUTO_STREAM_ROWS rows, else "local".
    l, m, t, q:      landmark count, embedding dim per block, SD subset size,
                     ensemble blocks, as in the paper. rff reads only m (its
                     output has 2m features).
    iters, n_init:   Lloyd cap and k-means++ restarts (best inertia wins).
    decay, epochs:   minibatch backend: sufficient-stat decay and stream passes.
    block_rows:      blocking used when wrapping an in-memory array.
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
        decay: float = 0.9,
        epochs: int = 1,
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
        self.decay, self.epochs = decay, epochs
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

    def _choose_backend(self, X) -> str:
        if self.backend != "auto":
            return self.backend
        if isinstance(X, BlockStore) or len(X) >= AUTO_STREAM_ROWS:
            return "stream"
        return "local"

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

    def _phase1(self, X, seed: int, dev: torch.device, backend_name: str = "local"):
        """The backend-independent front of every fit and sweep: blocked host
        view, reservoir sample, embedding fit, seeding pool. Returns
        (store, array, params, pool, s_seed); k-means++ draws come off
        ``s_seed`` per restart, identically for fit() and sweep(). Only the
        local backend gets the whole array on the device; the streaming ones
        stay O(block) there."""
        self.phases_ = {}
        array = None
        with self._phase("host_view", dev):
            if isinstance(X, BlockStore):
                self._reject_sharded(X, "fit")
                store = X
            else:
                X = _as_tensor(X)
                # The host copy is deliberate: sampling through the same
                # blocking on every backend keeps phase 1 identical across them.
                store = BlockStore.from_array(
                    X.detach().to("cpu", torch.float32).numpy(), self.block_rows
                )
                if backend_name == "local":
                    array = X.to(dev, torch.float32)
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
        return store, array, params, pool, s_seed

    @staticmethod
    def _seed_inits(pool: torch.Tensor, s_seed: int, k: int, discrepancy: str,
                    restarts: int) -> list[torch.Tensor]:
        """k-means++ inits of restarts 0..restarts-1, restart r drawn from
        ``restart_generator(s_seed, r)``."""
        return [kmeanspp_init(restart_generator(s_seed, r), pool, k, discrepancy)
                for r in range(restarts)]

    def _prepare(self, X, seed: int, dev: torch.device, backend_name: str = "local") -> FitContext:
        """Phase 1 and the k-means++ seeding of every restart."""
        store, array, params, pool, s_seed = self._phase1(X, seed, dev, backend_name)
        with self._phase("seed", dev):
            inits = self._seed_inits(pool, s_seed, self.k, params.discrepancy,
                                     max(1, self.n_init))
        return FitContext(
            store=store, array=array, params=params, k=self.k, inits=inits,
            iters=self.iters, policy=self.policy, device=dev, decay=self.decay,
            epochs=self.epochs,
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
        name = self._choose_backend(X)
        backend = get_backend(name)
        get_embedding(self.method)
        ctx = self._prepare(X, self.random_state if seed is None else seed, dev, name)
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

    def sweep(self, X, k_grid, *, restarts: int | None = None, seed: int | None = None,
              checkpoint_dir=None):
        """Embed-once model selection: embed the data once, then run
        ``restarts`` k-means++ restarts for every k in ``k_grid`` over the
        cached embedding, one engine pass feeding every candidate per Lloyd
        iteration. Backends "local" and "stream" (per ``backend=`` or the auto
        dispatch); the stream backend stages Y under the policy's
        ``cache_dtype`` and decodes each block inside ``fused_dequant_step``.

        ``sweep(k_grid=[k], restarts=1)`` gives the labels of ``fit`` at k from
        the same seed. The estimator adopts the best candidate (``model_``,
        ``labels_``, ``inertia_``, ``n_iter_``, ``backend_``); ``phases_``
        gains ``embed_cache``.

        Args:
            X: (n, d) array (numpy or torch) or a BlockStore.
            k_grid: candidate cluster counts.
            restarts: k-means++ restarts per k; ``None`` uses ``n_init``.
            seed: root seed; ``None`` uses ``random_state``.
            checkpoint_dir: not ported yet (raises ``NotImplementedError``).

        Returns:
            A ``SweepResult``.
        """
        from repro_torch.sweep import sweep_estimator

        return sweep_estimator(self, X, k_grid, restarts=restarts, seed=seed,
                               checkpoint_dir=checkpoint_dir)

    def _fit_meta(self, **kw) -> FitMeta:
        return FitMeta(
            k=self.k, method=self.method,
            kernel_name=getattr(self.kernel_, "name", ""),
            l=self.l, m=self.m, t=self.t, q=self.q, iters_cap=self.iters,
            decay=self.decay, epochs=self.epochs, landmark_sample=self.landmark_sample, seed_sample=self.seed_sample,
            block_rows=self.block_rows, random_state=self.random_state, **kw,
        )

    # ------------------------------------------------------------ inference

    def _require_model(self) -> ClusterModel:
        if self.model_ is None:
            raise RuntimeError("estimator is not fitted; call fit()")
        return self.model_

    @staticmethod
    def _reject_sharded(store: BlockStore, op: str) -> None:
        """A shard() of a store covers only a subset of global rows; a dense
        (n,)-shaped answer would silently hold -1 for every unvisited row."""
        covered = sum(store.rows_of(i) for i in range(store.num_blocks))
        if covered != store.n:
            raise ValueError(
                f"{op} got a sharded BlockStore covering {covered} of {store.n} "
                f"rows; run {op} per shard or pass the unsharded store"
            )

    def predict(self, X) -> np.ndarray:
        """Nearest-centroid labels of unseen rows, (n,) int32 on the host. A
        BlockStore streams through the engine block by block."""
        model = self._require_model()
        if isinstance(X, BlockStore):
            from repro_torch.stream.engine import map_reduce

            self._reject_sharded(X, "predict")
            dev = resolve_device(self.device)
            model = model.to(dev)
            labels = np.full(X.n, -1, dtype=np.int32)

            def _emit(i, out):
                lo = X.row_offset(i)
                labels[lo:lo + out.shape[0]] = out.cpu().numpy()

            map_reduce(
                X, lambda blk: ops.predict_block(blk, model.params, model.centroids,
                                              policy=self.policy),
                lambda acc, _: acc, None, prefetch=self.policy.prefetch, emit=_emit,
                device=dev, label="predict",
            )
            return labels
        labels = model.predict(X, policy=self.policy, device=self.device)
        return labels.cpu().numpy().astype(np.int32)

    def transform(self, X):
        """The fitted embedding Y = f(X): an (n, m) f32 tensor on the fit's
        device for an array, a host-staged BlockStore of embedded blocks for a
        BlockStore (still O(block) on the device)."""
        from repro_torch import embed

        dev = resolve_device(self.device)
        model = self._require_model().to(dev)
        if isinstance(X, BlockStore):
            from repro_torch.stream.lloyd import stream_embed

            return stream_embed(X, model.params, policy=self.policy, device=dev)
        return embed.transform(model.params, _as_tensor(X).to(dev, torch.float32), self.policy)

    def score(self, X) -> float:
        """Negative inertia of X under the fitted centroids (higher is better)."""
        dev = resolve_device(self.device)
        model = self._require_model().to(dev)
        if isinstance(X, BlockStore):
            from repro_torch.stream.engine import map_reduce

            self._reject_sharded(X, "score")
            total = map_reduce(
                X, lambda blk: block_cost(ops.embed_block_map(blk, model.params,
                                                          policy=self.policy),
                                          model.centroids, model.discrepancy),
                lambda acc, c: acc + c, torch.zeros((), device=dev),
                prefetch=self.policy.prefetch, device=dev, label="score",
            )
            return -float(total)
        Y = self.transform(X)
        return -float(block_cost(Y, model.centroids, model.discrepancy))
