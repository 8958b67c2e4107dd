"""Multi-model registry with zero-downtime hot swap.

The registry holds several live, named serving models (per kernel, per
tenant, A/B variants) — each a `ServingModel` bundling a fitted
`ClusterModel` with its own embed+assign closure over one fixed
(max_batch, d) device buffer (`make_process_fn`). Sources are
anything the rest of the stack produces: a `ClusterModel`, a `SweepResult`
(the selected winner is served), a checkpoint directory (cluster-model OR
sweep-result artifact, via `distributed.checkpoint.load_any_model`), or a
bare `(B, d) -> labels` callable for harnesses.

Hot swap (`swap(name, source)`) is the zero-downtime path: the replacement
entry is built and WARMED — its closure executed once, which loads (on a
fresh checkout, builds) the member's CUDA library and makes its first
launch — on the swapping thread, off the hot path, and only then is the
name's pointer
flipped under the registry lock. A flush that already resolved the old entry
finishes on the old model; every flush that resolves after the flip gets the
new one — no request is dropped and no batch is ever served a mixed model
(the tier resolves exactly once per batch). Entries are versioned so every
response can say
which model generation answered it.
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ServingModel:
    """One live registry entry: an immutable (model, closure, version)
    snapshot. Batches hold a reference to the whole entry while they
    process, so a concurrent swap can never tear a batch."""

    name: str
    version: int
    process: Callable[[np.ndarray], np.ndarray]  # (B, d) -> (B,) int labels
    d: int  # input dimensionality (0 = unknown, callable source without d)
    model: Any = None  # the ClusterModel, None for bare-callable sources

    def __repr__(self):  # keep failure messages readable
        return f"ServingModel({self.name!r}, v{self.version}, d={self.d})"


class ModelRegistry:
    """Named `ServingModel`s with atomic pointer-flip replacement.

    All mutation is lock-protected; `resolve` is one dict read under the
    lock — the atomic snapshot the serving tier takes per batch. Sources can
    be a fitted `ClusterModel`, a `SweepResult` (its best candidate), a
    checkpoint path, or a bare `(X) -> labels` callable; `swap` replaces a
    live entry atomically (zero-downtime hot swap) and `evict` removes it.
    Every entry built from a model serves on ``device`` (default: the card;
    ``"cpu"`` for the plain path); a bare callable takes no device.

    Example:
        >>> import numpy as np
        >>> from repro_torch.api import ModelRegistry
        >>> reg = ModelRegistry(max_batch=8)
        >>> _ = reg.register("echo", lambda X: np.zeros(len(X), np.int32), d=4)
        >>> reg.names()
        ['echo']
    """

    def __init__(self, *, max_batch: int = 256, policy=None, device=None):
        self.max_batch = int(max_batch)
        self.policy = policy
        self.device = device
        self._entries: dict[str, ServingModel] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- building

    def _build(self, name: str, source, *, version: int, d: int | None) -> ServingModel:
        if callable(source) and not hasattr(source, "centroids"):
            return ServingModel(name=name, version=version, process=source,
                                d=int(d or 0), model=None)
        model = self._as_cluster_model(source, self.device)
        process = make_process_fn(
            model, max_batch=self.max_batch, policy=self.policy, device=self.device
        )
        return ServingModel(name=name, version=version, process=process,
                            d=int(model.params.d), model=model)

    @staticmethod
    def _as_cluster_model(source, device):
        """ClusterModel | SweepResult | checkpoint path -> ClusterModel."""
        if isinstance(source, (str, Path)):
            from repro_torch.distributed.checkpoint import load_any_model

            return load_any_model(source, device=device)
        if hasattr(source, "best"):  # SweepResult: serve the selected winner
            return source.best
        return source

    @staticmethod
    def _warm(entry: ServingModel) -> None:
        """Execute the closure once, off the hot path: the first real batch
        after a register/swap must not pay for loading (or building) the
        member's CUDA library and its first launch."""
        if entry.d > 0:
            entry.process(np.zeros((1, entry.d), np.float32))

    # ------------------------------------------------------------ lifecycle

    def register(self, name: str, source, *, d: int | None = None,
                 warm: bool = True) -> ServingModel:
        """Add a NEW named model (use `swap` to replace a live one)."""
        entry = self._build(name, source, version=1, d=d)
        if warm:
            self._warm(entry)
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    f"model {name!r} already registered (version "
                    f"{self._entries[name].version}); use swap() to replace it"
                )
            self._entries[name] = entry
        obs.counter(f"serve.model.{name}.registered").inc()
        return entry

    def resolve(self, name: str) -> ServingModel:
        """The current entry for `name` — ONE atomic pointer read. Callers
        that hold the returned entry keep serving its model even across a
        concurrent swap (that is the point)."""
        with self._lock:
            entry = self._entries.get(name)
            known = sorted(self._entries)
        if entry is None:
            raise KeyError(
                f"no serving model {name!r} (registered: {known or 'none'})"
            )
        return entry

    def swap(self, name: str, source, *, d: int | None = None,
             warm: bool = True) -> ServingModel:
        """Zero-downtime replacement: build + warm the new entry off the hot
        path, then flip the pointer. In-flight batches finish on the old
        entry; the old model is unreferenced (and collectable) once they do."""
        old = self.resolve(name)  # fail before building if name is unknown
        with obs.span("serve.swap", cat="serve", model=name) as sp:
            entry = self._build(name, source, version=old.version + 1, d=d)
            if warm:
                self._warm(entry)
            with self._lock:
                # re-read: concurrent swaps serialize on version monotonicity
                current = self._entries[name]
                entry = dataclasses.replace(entry, version=current.version + 1)
                self._entries[name] = entry
            sp.set(version=entry.version)
        obs.counter("serve.swaps").inc()
        obs.counter(f"serve.model.{name}.swaps").inc()
        return entry

    def evict(self, name: str) -> ServingModel:
        """Remove a model. A flush that already resolved the entry finishes
        normally (it holds the entry); requests still queued for the name
        when their flush runs get typed error responses (the tier resolves
        per batch and fails the batch on KeyError — never the dispatcher);
        NEW requests are rejected at submit with the registered-names
        KeyError."""
        with self._lock:
            entry = self._entries.pop(name, None)
            known = sorted(self._entries)
        if entry is None:
            raise KeyError(
                f"no serving model {name!r} (registered: {known or 'none'})"
            )
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def make_process_fn(model, *, max_batch: int, policy=None, device=None):
    """One embed+assign dispatch per micro-batch (labels only, no (Z, g)
    sufficient statistics): ``ops.predict_block`` on ``device`` (default: the
    card; ``"cpu"`` for the plain path).

    The params and centroids move to the device once, here. Each call copies
    its (B, d) rows into one (max_batch, d) device buffer, zero-padded past
    B, and returns the first B labels as int32 on the host (the copy back is
    the call's one synchronisation). The padding keeps every flush at one
    shape whatever B (one launch geometry on the card, one GEMM shape on the
    plain route) and the buffer fixed, for a CUDA graph to replay later; the
    labels of a row do not depend on the others (``ops.assign_labels``). A
    lock serialises callers of one closure, since they share its buffer.
    """
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    model = model.to(dev)
    params, centroids = model.params, model.centroids
    buf = torch.zeros((max_batch, int(params.d)), dtype=torch.float32, device=dev)
    state = {"filled": 0}  # rows of buf that may hold an earlier batch's data
    lock = threading.Lock()

    def process(X: np.ndarray) -> np.ndarray:
        b = X.shape[0]
        if b > max_batch:
            raise ValueError(f"batch of {b} rows exceeds max_batch {max_batch}")
        # a read-only array (a view of another package's buffer) is copied once
        rows = torch.from_numpy(np.require(X, np.float32, ["C", "W"]))
        with lock:
            buf[:b].copy_(rows)
            if state["filled"] > b:
                buf[b:state["filled"]].zero_()
            state["filled"] = b
            labels = ops.predict_block(buf, params, centroids, policy=policy)
            return labels[:b].to(torch.int32).cpu().numpy()

    return process
