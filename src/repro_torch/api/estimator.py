"""`KernelKMeans`: the estimator of the port, on the ``local``,
``shard_map``, ``stream``, ``stream_shard`` and ``minibatch`` backends, its
embed-once ``sweep``, the online ``partial_fit``, and ``save`` / ``load`` of
the `ClusterModel` artifact in the JAX package's checkpoint format.

Phase 1 runs here, identically for every backend: a reservoir sample of the
data's rows, drawn over its ``block_rows`` blocking from the seed alone,
selects landmarks, the embedding member fits its params on the sample, the
seeding pool is embedded, and k-means++ seeds one init per restart. A fit
that holds the whole array on its device (``local``, ``shard_map``) gathers
the sampled rows there; the streaming backends gather them from a blocked
host view. Phase 2 (Lloyd) runs in the backend, so ``local`` and
``stream`` reach the same fixed point from the same init. Everything runs on
the card unless the caller passes ``device="cpu"``; the streaming backends
keep O(block) of the data on it. With a ``mesh=`` the mesh's devices decide:
phase 1 runs on its first data device.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.backends import FitContext
from repro_torch.api.model import ClusterModel, FitMeta
from repro_torch.api.registry import get_backend, get_embedding, resolve_kernel
from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
from repro_torch.core.lloyd import assign_stats, block_cost, centroid_update, kmeanspp_init
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.policy import ComputePolicy
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.reservoir import block_row_counts, reservoir_rows, reservoir_sample

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
    backend:         "local" | "shard_map" | "stream" | "stream_shard" |
                     "minibatch" | "auto". auto -> "stream_shard" for a
                     BlockStore input plus a mesh with more than one data
                     device, "stream" for any other BlockStore input,
                     "shard_map" for an array when a mesh was given, "stream"
                     for an array of at least AUTO_STREAM_ROWS rows, else
                     "local".
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
    mesh:            `repro_torch.launch.mesh.Mesh` of the shard_map /
                     stream_shard backends; its first data device is the
                     fit's device, and a ``device`` that differs raises.
    scheduler:       stream_shard pass scheduling: "lockstep" (fixed block ->
                     shard placement, one device reduction an iteration) or
                     "pool" (`repro_torch.pool`: leased tasks that survive
                     dead and slow workers, merged on the host in block
                     order).

    After fit: `model_`, `labels_`, `inertia_`, `n_iter_`, `kernel_`,
    `backend_`, `phases_` (wall seconds per phase) and `fit_report_` (a
    `repro_torch.obs.FitReport`: phases, the inertia trajectory, centroid
    shifts, engine passes, blocks and bytes streamed, per-device blocks;
    also attached to `model_.report`). `sweep` and `partial_fit` set them
    too.

    Persistence: `save(dir)` writes `model_` as a checkpoint the JAX package
    also reads, `KernelKMeans.load(dir)` rebuilds a fitted estimator from
    one written by either package, and `fit(..., checkpoint_dir=dir)` saves
    the streaming backends' Lloyd state after every iteration, so that a
    killed fit refitted with the same seed and directory resumes.
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
        mesh=None,
        scheduler: str = "lockstep",
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
        self.mesh = mesh
        self.scheduler = scheduler

        self.model_: ClusterModel | None = None
        self.labels_: np.ndarray | None = None
        self.inertia_: float | None = None
        self.n_iter_: int | None = None
        self.kernel_: Kernel | None = None
        self.backend_: str | None = None
        self.phases_: dict[str, float] = {}
        self.fit_report_: obs.FitReport | None = None
        self._pf_state: tuple[torch.Tensor, torch.Tensor, int] | None = None  # (Z, g, rows)

    # ------------------------------------------------------------- dispatch

    def _choose_backend(self, X) -> str:
        if self.backend != "auto":
            return self.backend
        if isinstance(X, BlockStore):
            # Blocked input and a mesh of more than one data device: shard
            # the stream across it (one producer and one block shard a device).
            if self.mesh is not None:
                from repro_torch.stream.sharded import shard_devices

                if len(shard_devices(self.mesh)) > 1:
                    return "stream_shard"
            return "stream"
        if self.mesh is not None:
            return "shard_map"
        if len(X) >= AUTO_STREAM_ROWS:
            return "stream"
        return "local"

    def _device(self) -> torch.device:
        """Where this estimator runs: the mesh's first data device when it has
        a mesh (``device=`` must then name that device), else ``device``
        (default: the card)."""
        if self.mesh is None:
            return resolve_device(self.device)
        from repro_torch.stream.sharded import shard_devices

        first = shard_devices(self.mesh)[0]
        want = None if self.device is None else torch.device(self.device)
        if want is not None and (want.type != first.type or
                                 want.index not in (None, first.index)):
            raise ValueError(
                f"device={self.device!r} disagrees with the mesh, whose first data device "
                f"is {first}; pass device=None or the mesh's device")
        return first

    def _resolve_kernel(self, sample: torch.Tensor) -> Kernel:
        if not isinstance(self.kernel, Kernel) and self.kernel == "rbf" \
                and not self.kernel_params:
            return self_tuned_rbf(sample, seed=self.random_state)
        return resolve_kernel(self.kernel, self.kernel_params)

    @contextmanager
    def _phase(self, name: str, dev: torch.device):
        """Wall time of one phase, synchronised with the card at both ends,
        inside one ``phase.<name>`` span (opened after the first sync,
        closed after the second)."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with obs.span(f"phase.{name}", cat="phase"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self.phases_[name] = self.phases_.get(name, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------ lifecycle

    def _fit_params_and_pool(self, sample: torch.Tensor, s_fit: int):
        """The shared front half of phase 1: resolve the kernel, fit the
        member's params on the sample, embed the seeding pool. Used by fit()
        and sweep() (reservoir sample) and partial_fit() (first block)."""
        self.kernel_ = self._resolve_kernel(sample)
        params = get_embedding(self.method).fit(
            s_fit, sample, self.kernel_, l=self.l, m=self.m, t=self.t, q=self.q
        )
        pool = ops.embed_block_map(sample[: self.seed_sample], params, policy=self.policy)
        return params, pool

    def _phase1(self, X, seed: int, dev: torch.device, backend_name: str = "local"):
        """The backend-independent front of every fit and sweep: reservoir
        sample, embedding fit, seeding pool. Returns (store, array, params,
        pool, s_seed); k-means++ draws come off ``s_seed`` per restart,
        identically for fit() and sweep(). The ``local`` and ``shard_map``
        backends get the whole array on the device, gather the sample there
        and build no host view (``store`` is None); the streaming ones take a
        blocked host view and stay O(block) on the device. Both draw the same
        rows from the same seed."""
        store = array = None
        with self._phase("host_view", dev):
            if isinstance(X, BlockStore):
                self._reject_sharded(X, "fit")
                store = X
            elif backend_name in ("local", "shard_map"):
                array = _as_tensor(X).to(dev, torch.float32)
            if store is not None or array is not None:
                # nothing to copy; the span still opens, so its histogram reads ~0
                with obs.span("host_view.copy", cat="phase", observe=True, bytes=0):
                    pass
            else:
                X = _as_tensor(X)
                with obs.span("host_view.copy", cat="phase", observe=True,
                              bytes=4 * X.numel()):
                    host = X.detach().to("cpu", torch.float32).numpy()
                store = BlockStore.from_array(host, self.block_rows)
        s_sample, s_fit, s_seed = phase1_seeds(seed)
        with self._phase("reservoir", dev):
            if store is None:
                obs.counter("phase1.device_reservoir").inc()
                rows = reservoir_rows(block_row_counts(array.shape[0], self.block_rows),
                                      self.landmark_sample, seed=s_sample)
                sample = array.index_select(0, torch.from_numpy(rows).to(dev))
            else:
                sample = torch.from_numpy(
                    reservoir_sample(store, self.landmark_sample, seed=s_sample)
                ).to(dev)
        with self._phase("embed_fit", dev):
            params, pool = self._fit_params_and_pool(sample, s_fit)
        return store, array, params, pool, s_seed

    @staticmethod
    def _seed_inits(pool: torch.Tensor, s_seed: int, k: int, discrepancy: str,
                    restarts: int, policy: ComputePolicy | None = None) -> list[torch.Tensor]:
        """k-means++ inits of restarts 0..restarts-1, restart r drawn from
        ``restart_generator(s_seed, r)``."""
        return [kmeanspp_init(restart_generator(s_seed, r), pool, k, discrepancy, policy)
                for r in range(restarts)]

    def _prepare(self, X, seed: int, dev: torch.device, backend_name: str = "local",
                 checkpoint_dir=None) -> FitContext:
        """Phase 1 and the k-means++ seeding of every restart."""
        self.phases_ = {}
        store, array, params, pool, s_seed = self._phase1(X, seed, dev, backend_name)
        with self._phase("seed", dev):
            inits = self._seed_inits(pool, s_seed, self.k, params.discrepancy,
                                     max(1, self.n_init), self.policy)
        return FitContext(
            store=store, array=array, params=params, k=self.k, inits=inits,
            iters=self.iters, policy=self.policy, device=dev, decay=self.decay,
            epochs=self.epochs, checkpoint_dir=checkpoint_dir, mesh=self.mesh,
            scheduler=self.scheduler,
        )

    def fit(self, X, y=None, *, seed: int | None = None,
            checkpoint_dir: str | Path | None = None) -> "KernelKMeans":
        """Fit on an (n, d) array (numpy or torch) or a BlockStore.

        ``checkpoint_dir`` turns on mid-fit Lloyd checkpoints on the stream
        and minibatch backends: the state after every iteration (epoch for
        minibatch) is saved crash-atomically under
        ``checkpoint_dir/restart_<r>/``, and a killed fit refitted with the
        same seed and directory resumes mid-Lloyd. Phase 1 runs again (it is
        seed-deterministic); no completed iteration does. The local backend
        ignores it.

        Args:
            X: the data.
            y: ignored (sklearn signature compatibility).
            seed: root seed; ``None`` uses ``random_state``.
            checkpoint_dir: root directory of the mid-fit checkpoints, or
                ``None`` for none.

        Returns:
            self, fitted.
        """
        dev = self._device()
        name = self._choose_backend(X)
        backend = get_backend(name)
        get_embedding(self.method)
        metrics_before = obs.snapshot("engine.")
        ctx = self._prepare(X, self.random_state if seed is None else seed, dev, name,
                            checkpoint_dir)
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
        self._attach_report(name, metrics_before, trajectory=out.trajectory,
                            shifts=out.shifts, iters=out.iters, rows_seen=out.rows_seen)
        self._pf_state = None
        return self

    def fit_predict(self, X, *, seed: int | None = None) -> np.ndarray:
        """``fit(X, seed=seed).labels_``."""
        return self.fit(X, seed=seed).labels_

    def sweep(self, X, k_grid, *, restarts: int | None = None, seed: int | None = None,
              checkpoint_dir=None):
        """Embed-once model selection: embed the data once, then run
        ``restarts`` k-means++ restarts for every k in ``k_grid`` over the
        cached embedding, one engine pass feeding every candidate per Lloyd
        iteration. Backends "local", "stream" and "stream_shard" (per
        ``backend=`` or the auto dispatch); the stream backends stage Y under
        the policy's ``cache_dtype`` and decode each block inside
        ``fused_dequant_step``, on ``stream_shard`` across the mesh's data
        devices.

        ``sweep(k_grid=[k], restarts=1)`` gives the labels of ``fit`` at k from
        the same seed. The estimator adopts the best candidate (``model_``,
        ``labels_``, ``inertia_``, ``n_iter_``, ``backend_``); ``phases_``
        gains ``embed_cache``.

        Args:
            X: (n, d) array (numpy or torch) or a BlockStore.
            k_grid: candidate cluster counts.
            restarts: k-means++ restarts per k; ``None`` uses ``n_init``.
            seed: root seed; ``None`` uses ``random_state``.
            checkpoint_dir: persists the embed-once stage (params, seeding
                pool and Y in the policy's ``cache_dtype`` wire form) before
                clustering and the ``SweepResult`` after, so that an
                interrupted sweep rerun with the same seed and directory
                resumes past the embedding pass (``phases_`` then has
                ``stage_load`` and no ``embed_cache``; ``result.resumed``).

        Returns:
            A ``SweepResult``.
        """
        from repro_torch.sweep import sweep_estimator

        return sweep_estimator(self, X, k_grid, restarts=restarts, seed=seed,
                               checkpoint_dir=checkpoint_dir)

    def partial_fit(self, X, *, seed: int | None = None) -> "KernelKMeans":
        """The online face of the minibatch backend: one decayed (Z, g) update
        per call, O(block) forever. On a cold estimator the first call fits
        the embedding on that block and seeds the centroids from it (the fit
        and seeding parts of ``phase1_seeds(seed)``); on a fitted or loaded
        estimator it continues from ``model_`` with fresh decayed statistics
        and the model's ``rows_seen``. Each call embeds the block, assigns it
        (``assign_stats``), updates (Z, g) and the centroids, and reports the
        block's cost under the new centroids as ``inertia_``. ``phases_`` and
        ``fit_report_`` describe the call: one phase, ``partial_fit``, and
        the trajectory ``[inertia_]``.

        Args:
            X: one (b, d) block of the stream (numpy or torch).
            seed: cold-start root seed; ``None`` uses ``random_state``.

        Returns:
            self, updated in place.
        """
        dev = self._device()
        metrics_before = obs.snapshot("engine.")
        self.phases_ = {}
        with self._phase("partial_fit", dev):
            self._partial_fit(_as_tensor(X).to(dev, torch.float32), seed, dev)
        self._attach_report("minibatch", metrics_before, trajectory=[self.inertia_],
                            iters=0, rows_seen=self.model_.meta.rows_seen)
        return self

    def _partial_fit(self, Xb: torch.Tensor, seed: int | None, dev: torch.device) -> None:
        """The body of one ``partial_fit`` call."""
        if self.model_ is None:
            # landmark-free members read only the input dim from the first
            # block, but k-means++ still needs k rows; kernelized members need
            # their l landmarks
            need, what = (
                (self.k, f"k={self.k} rows to seed centroids")
                if get_embedding(self.method).landmark_free
                else (self.l, f"l={self.l} rows to fit the embedding")
            )
            if Xb.shape[0] < need:
                raise ValueError(
                    f"partial_fit cold start needs the first block to hold at least {what}, "
                    f"got {Xb.shape[0]}; buffer a larger first block"
                )
            _, s_fit, s_seed = phase1_seeds(self.random_state if seed is None else seed)
            params, pool = self._fit_params_and_pool(Xb[: self.landmark_sample], s_fit)
            centroids = kmeanspp_init(restart_generator(s_seed, 0), pool, self.k,
                                      params.discrepancy, self.policy)
            self._pf_state = (torch.zeros((self.k, params.m), device=dev),
                              torch.zeros((self.k,), device=dev), 0)
        else:
            model = self.model_.to(dev)
            params, centroids = model.params, model.centroids
            if self._pf_state is None:  # warm start from fit() or load()
                self._pf_state = (torch.zeros((self.k, params.m), device=dev),
                                  torch.zeros((self.k,), device=dev), model.meta.rows_seen)
        Z, g, rows = self._pf_state
        y = ops.embed_block_map(Xb, params, policy=self.policy)
        Z_b, g_b, labels = assign_stats(y, centroids, self.k, params.discrepancy,
                                        policy=self.policy)
        Z = self.decay * Z + Z_b
        g = self.decay * g + g_b
        centroids = centroid_update(Z, g, centroids)
        inertia = float(block_cost(y, centroids, params.discrepancy))
        rows += int(Xb.shape[0])
        self._pf_state = (Z, g, rows)
        self.model_ = ClusterModel(
            params=params, centroids=centroids,
            inertia=torch.tensor(inertia, dtype=torch.float32),
            meta=self._fit_meta(backend="minibatch", rows_seen=rows, n_init=1),
        )
        self.labels_ = labels.cpu().numpy().astype(np.int32)
        self.inertia_ = inertia
        self.n_iter_ = 0
        self.backend_ = "minibatch"

    def _attach_report(self, backend_name: str, metrics_before: dict, *, trajectory=(),
                       shifts=(), iters: int = 0, rows_seen: int = 0,
                       extra: dict | None = None) -> obs.FitReport:
        """Assemble the `FitReport` of the run that just finished from
        ``phases_`` and the engine metrics since ``metrics_before``, and
        surface it as ``fit_report_`` and ``model_.report``."""
        d = obs.delta(metrics_before, obs.snapshot("engine."))
        report = obs.FitReport(
            backend=backend_name, phases=dict(self.phases_),
            inertia_trajectory=[float(v) for v in trajectory],
            centroid_shifts=[float(v) for v in shifts], iters=int(iters),
            rows_seen=int(rows_seen), extra=dict(extra or {}),
            **obs.report_from_metrics_delta(d),
        )
        self.fit_report_ = report
        if self.model_ is not None:
            self.model_.report = report
        return report

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
        BlockStore streams through the engine block by block.

        Traced, an array's call is one ``predict`` span (attr ``rows``)
        holding ``predict.prepare`` (``core.kkmeans.predict``),
        ``predict.wait`` (the labels' copy to the host, the call's one wait
        for the card) and ``predict.finish``; ``predict`` and
        ``predict.wait`` also add their seconds to the ``span.<name>``
        histograms."""
        model = self._require_model()
        if isinstance(X, BlockStore):
            from repro_torch.stream.engine import map_reduce

            self._reject_sharded(X, "predict")
            dev = self._device()
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
        with obs.span("predict", cat="predict", observe=True, rows=len(X)):
            labels = model.predict(X, policy=self.policy, device=self._device())
            with obs.span("predict.wait", cat="predict", observe=True):
                labels = labels.cpu()
            with obs.span("predict.finish", cat="predict"):
                return labels.numpy().astype(np.int32)

    def transform(self, X):
        """The fitted embedding Y = f(X): an (n, m) f32 tensor on the fit's
        device for an array, a host-staged BlockStore of embedded blocks for a
        BlockStore (still O(block) on the device)."""
        from repro_torch import embed

        dev = self._device()
        model = self._require_model().to(dev)
        if isinstance(X, BlockStore):
            from repro_torch.stream.lloyd import stream_embed

            return stream_embed(X, model.params, policy=self.policy, device=dev)
        return embed.transform(model.params, _as_tensor(X).to(dev, torch.float32), self.policy)

    def score(self, X) -> float:
        """Negative inertia of X under the fitted centroids (higher is better)."""
        dev = self._device()
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

    # ---------------------------------------------------------- persistence

    def save(self, ckpt_dir: str | Path, *, step: int = 0) -> Path:
        """Persist ``model_`` as a ClusterModel checkpoint (crash-atomic, in
        the JAX package's format). Returns the written step directory."""
        from repro_torch.distributed.checkpoint import save_cluster_model

        return save_cluster_model(ckpt_dir, self._require_model(), step=step)

    @classmethod
    def load(cls, ckpt_dir: str | Path, *, step: int | None = None,
             policy: ComputePolicy | None = None, device=None) -> "KernelKMeans":
        """A fitted estimator from a ClusterModel checkpoint written by either
        package, whichever backend fit it: the hyperparameters rebuilt from
        its ``FitMeta``, the model on ``device`` (default: the card).

        Args:
            ckpt_dir: the checkpoint root (as passed to ``save``).
            step: the step to load; ``None`` for the latest.
            policy: ``ComputePolicy`` for what follows (``None``: defaults).
            device: where the model lives and later calls run.
        """
        from repro_torch.distributed.checkpoint import load_cluster_model

        model = load_cluster_model(ckpt_dir, step=step, device=device)
        meta = model.meta
        # The kernel comes back resolved when the member's params carry it
        # (every built-in does).
        kernel = getattr(model.params, "kernel", None)
        est = cls(
            model.k,
            kernel=kernel if kernel is not None else (meta.kernel_name or "rbf"),
            method=meta.method,
            backend=meta.backend if meta.backend != "unknown" else "auto",
            # the recorded fit hyperparameters, so that a refit from the same
            # seed reproduces the fit; artifacts that recorded none fall back
            # to shapes and the constructor's defaults
            l=meta.l or getattr(model.params, "l", 0) or 300,
            m=meta.m or (model.params.R.shape[1] if hasattr(model.params, "R")
                         else model.params.m),
            t=meta.t, q=meta.q, iters=meta.iters_cap or 20,
            n_init=max(1, meta.n_init), decay=meta.decay, epochs=meta.epochs,
            landmark_sample=meta.landmark_sample or 4096,
            seed_sample=meta.seed_sample or 1024,
            block_rows=meta.block_rows or 4096,
            random_state=meta.random_state, policy=policy, device=device,
        )
        est.kernel_ = kernel
        est.model_ = model
        est.inertia_ = float(model.inertia)
        est.n_iter_ = meta.iters
        est.backend_ = meta.backend
        return est
