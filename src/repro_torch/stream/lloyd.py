"""Streaming Lloyd drivers on top of the block engine.

Two regimes, both O(block) in device memory and both sharing the reduce step
of `core.lloyd` (`centroid_update`):

  * `ooc_lloyd`: exact out-of-core Lloyd. Per iteration, stream every block,
    accumulate the global (Z, g), update the centroids once. Same fixed point
    as the in-memory `core.lloyd.lloyd` from the same init: only the
    summation grouping of Z differs.
  * `minibatch_lloyd`: single-pass streaming Lloyd with decayed sufficient
    statistics Z <- gamma Z + Z_b, for streams where "iterate until
    convergence" is not an option.

Blocks hold raw inputs X (pass `coeffs=`, the fitted params of any registered
member: each block is embedded and assigned in one fused kernel where the
member has one) or embedded rows Y (pass `discrepancy=`; `stream_embed`
stages Y blocks to host memory once, under the policy's `cache_dtype`; a
compressed store streams in its wire form and each block's step decodes it
inside `fused_dequant_step`).

Labels live on the host, (n,) int32: on a card each block's labels are
copied into pinned memory without a sync, and the pass synchronizes once.
These drivers back the "stream" and "minibatch" backends of
`repro_torch.api.KernelKMeans`. They run on one device; `devices=` and
`mesh=` raise `NotImplementedError` until the slice that ports the sharded
stream. `checkpoint_dir=` saves the state after every iteration (epoch for
minibatch) crash-atomically, and a refit with the same data, k and init
resumes from it and reaches the uninterrupted fit's labels, iterations and
inertia bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.apnc import Discrepancy
from repro_torch.core.lloyd import centroid_update, kmeanspp_init
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.embed.base import EmbeddingParams
from repro_torch.kernels import ops
from repro_torch.launch.elastic import resume_lloyd_state
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.stream.blockstore import BlockStore, WritableBlockStore
from repro_torch.stream.engine import cache_embedding, map_reduce
from repro_torch.stream.reservoir import reservoir_sample


class StreamLloydResult(NamedTuple):
    labels: np.ndarray  # (n,) int32, host-resident
    centroids: torch.Tensor  # (k, m)
    inertia: float  # sum of e(y_i, c_{pi(i)})
    iters: int  # iterations actually run
    rows_seen: int  # total rows streamed ((iters + 1) * n for exact)
    # Per-iteration inertia (exact: the cost of iteration t's assignment;
    # minibatch: per-epoch accumulated block costs), last entry the final
    # pass's, and per-update centroid shifts ||c_{t+1} - c_t||_F.
    trajectory: tuple = ()
    shifts: tuple = ()


class _HostLabels:
    """(n,) int32 labels on the host. On a card the buffer is pinned and each
    block's labels are copied into it on the compute stream without a sync;
    ``numpy()`` synchronizes once and returns a view of the buffer."""

    def __init__(self, n: int, device: torch.device):
        self.device = device
        self.buf = torch.full((n,), -1, dtype=torch.int32,
                              pin_memory=device.type == "cuda")

    def put(self, lo: int, labels: torch.Tensor) -> None:
        self.buf[lo:lo + labels.shape[0]].copy_(labels, non_blocking=True)

    def numpy(self) -> np.ndarray:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.buf.numpy()


def _not_ported(devices, mesh) -> None:
    if devices is not None or mesh is not None:
        raise NotImplementedError(
            "devices=/mesh= (the sharded stream) is not ported yet; see ROADMAP.md")


def _source(coeffs, discrepancy) -> str:
    if (coeffs is None) == (discrepancy is None):
        raise ValueError("pass exactly one of coeffs= (raw X blocks) or discrepancy= (Y blocks)")
    return coeffs.discrepancy if coeffs is not None else discrepancy


def stream_embed(
    store: BlockStore,
    coeffs: EmbeddingParams,
    *,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
) -> WritableBlockStore:
    """Algorithm 1 over a block stream: X blocks in, Y blocks staged to host
    memory under the policy's ``cache_dtype`` codec (O(n*m) host, O(block)
    device). Use when host memory holds Y and several Lloyd iterations will
    reuse it."""
    pol = as_policy(policy)
    return cache_embedding(
        store, lambda x: ops.embed_block_map(x, coeffs, policy=pol), d_out=coeffs.m,
        codec=pol.cache_dtype, prefetch=pol.prefetch if prefetch is None else prefetch,
        device=device,
    )


def _resolve_init(store, coeffs, discrepancy, k, init, generator, seed_sample, dev,
                  policy=None):
    if init is not None:
        return torch.as_tensor(init).to(dev, torch.float32)
    if generator is None:
        raise ValueError("provide generator= for k-means++ init or init= centroids")
    # One draw picks WHICH rows the reservoir keeps, the rest HOW k-means++
    # seeds among them.
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    sample = torch.from_numpy(reservoir_sample(store, seed_sample, seed=seed)).to(
        dev, torch.float32)
    if coeffs is not None:  # raw X rows: embed the reservoir before seeding
        sample = ops.embed_block_map(sample, coeffs, policy=policy)
    return kmeanspp_init(generator, sample, k, discrepancy)


def ooc_lloyd(
    store: BlockStore,
    k: int,
    *,
    coeffs: EmbeddingParams | None = None,
    discrepancy: Discrepancy | None = None,
    iters: int = 20,
    init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    seed_sample: int = 1024,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
    devices=None,
    mesh=None,
    checkpoint_dir=None,
) -> StreamLloydResult:
    """Exact out-of-core Lloyd: the update rule of `core.lloyd.lloyd`, memory
    O(block) on ``device`` (default: the card; ``"cpu"`` for the plain path).
    Stops early when no label changes, then assigns once more under the final
    centroids. ``init`` centroids, or a CPU ``generator`` for a k-means++
    init on a reservoir sample of ``seed_sample`` rows. ``checkpoint_dir``
    saves the state after every iteration and resumes a refit of the same
    data, k and init from the last one saved."""
    _not_ported(devices, mesh)
    disc = _source(coeffs, discrepancy)
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    dev = resolve_device(device)
    cell = [_resolve_init(store, coeffs, disc, k, init, generator, seed_sample, dev, pol)]
    m = int(cell[0].shape[1])
    map_fn = ops.lloyd_step_plan(params=coeffs, discrepancy=disc, policy=pol).block_map(cell)
    labels = _HostLabels(store.n, dev)
    prev = labels.numpy().copy()

    def emit(i, out):
        labels.put(store.row_offset(i), out[2])

    zero = (torch.zeros((k, m), device=dev), torch.zeros((k,), device=dev),
            torch.zeros((), device=dev))
    trajectory: list[float] = []
    shifts: list[float] = []
    it = 0
    changed = True
    fp = None
    if checkpoint_dir is not None:
        fp = ckpt.lloyd_fingerprint(kind="ooc", n=store.n, d=store.d, k=k, m=m, init=cell[0],
                                    cache_dtype=getattr(store, "codec", "f32"))
        state = resume_lloyd_state(checkpoint_dir, fingerprint=fp, devices_used=1)
        if state is not None:
            it, changed = state["step"], state["changed"]
            labels.buf.copy_(torch.from_numpy(state["labels"]))
            prev = state["labels"].copy()
            trajectory, shifts = list(state["trajectory"]), list(state["shifts"])
            cell[0] = torch.from_numpy(state["centroids"]).to(dev)
    while it < iters and changed:
        with obs.span("lloyd.iter", cat="lloyd", iter=it) as sp:
            Z, g, cost = map_reduce(
                store, map_fn,
                lambda acc, out: (acc[0] + out[0], acc[1] + out[1], acc[2] + out[3]),
                zero, prefetch=prefetch, emit=emit, device=dev,
            )
            new_c = centroid_update(Z, g, cell[0])
            shifts.append(float(torch.linalg.norm(new_c - cell[0])))
            trajectory.append(float(cost))
            sp.set(inertia=trajectory[-1], shift=shifts[-1])
            cell[0] = new_c
        cur = labels.numpy()
        changed = not np.array_equal(cur, prev)
        prev = cur.copy()
        it += 1
        if checkpoint_dir is not None:
            ckpt.save_lloyd_state(
                checkpoint_dir, step=it, centroids=cell[0], labels=prev,
                trajectory=trajectory, shifts=shifts, changed=changed, fingerprint=fp,
                devices_used=1,
            )

    inertia = _final_assign(store, coeffs, disc, cell, labels, prefetch, dev, pol)
    trajectory.append(inertia)
    return StreamLloydResult(
        labels.numpy().copy(), cell[0], inertia, it, (it + 1) * store.n,
        tuple(trajectory), tuple(shifts),
    )


def _final_assign(store, coeffs, disc, cell, labels: _HostLabels, prefetch, dev,
                  policy=None) -> float:
    """Final labels + inertia under the final centroids: one plan ``assign``
    per block (labels at index 0, cost at 1)."""
    plan = ops.lloyd_step_plan(params=coeffs, discrepancy=disc, policy=policy)

    def emit(i, out):
        labels.put(store.row_offset(i), out[0])

    inertia = map_reduce(
        store, plan.assign_map(cell), lambda acc, out: acc + out[1],
        torch.zeros((), device=dev), prefetch=prefetch, emit=emit, device=dev,
    )
    return float(inertia)


def minibatch_lloyd(
    store: BlockStore,
    k: int,
    *,
    coeffs: EmbeddingParams | None = None,
    discrepancy: Discrepancy | None = None,
    decay: float = 0.9,
    epochs: int = 1,
    init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    seed_sample: int = 1024,
    policy: ComputePolicy | None = None,
    prefetch: int | None = None,
    device=None,
    devices=None,
    mesh=None,
    checkpoint_dir=None,
) -> StreamLloydResult:
    """Single-pass (per epoch) streaming Lloyd with decayed sufficient stats:

        Z <- decay * Z + Z_b,   g <- decay * g + g_b,   c = Z / g

    The centroids move after every block, so one pass over the stream
    already clusters; decay < 1 forgets stale assignments.
    ``checkpoint_dir`` saves the state, (Z, g) included, after every epoch
    and resumes a refit of the same data, k, init and decay from the last
    one saved."""
    _not_ported(devices, mesh)
    disc = _source(coeffs, discrepancy)
    pol = as_policy(policy)
    prefetch = pol.prefetch if prefetch is None else prefetch
    dev = resolve_device(device)
    cell = [_resolve_init(store, coeffs, disc, k, init, generator, seed_sample, dev, pol)]
    m = int(cell[0].shape[1])
    map_fn = ops.lloyd_step_plan(params=coeffs, discrepancy=disc, policy=pol).block_map(cell)
    labels = _HostLabels(store.n, dev)
    state = [torch.zeros((k, m), device=dev), torch.zeros((k,), device=dev),
             torch.zeros((), device=dev)]

    def emit(i, out):
        labels.put(store.row_offset(i), out[2])

    def combine(acc, out):
        Z = decay * state[0] + out[0]
        g = decay * state[1] + out[1]
        state[0], state[1], state[2] = Z, g, state[2] + out[3]
        cell[0] = centroid_update(Z, g, cell[0])
        return acc

    # Per-epoch trajectory: the accumulated block costs of that epoch, each
    # under the centroids current when its block streamed.
    trajectory: list[float] = []
    seen_cost = 0.0
    start = 0
    fp = None
    if checkpoint_dir is not None:
        fp = ckpt.lloyd_fingerprint(kind="minibatch", n=store.n, d=store.d, k=k, m=m,
                                    init=cell[0], decay=decay,
                                    cache_dtype=getattr(store, "codec", "f32"))
        saved = resume_lloyd_state(checkpoint_dir, fingerprint=fp, devices_used=1)
        if saved is not None:
            start = saved["step"]
            labels.buf.copy_(torch.from_numpy(saved["labels"]))
            trajectory = list(saved["trajectory"])
            cell[0] = torch.from_numpy(saved["centroids"]).to(dev)
            state[:] = [torch.from_numpy(saved["stats"][name]).to(dev)
                        for name in ("Z", "g", "seen_cost")]
            seen_cost = float(state[2])
    for ep in range(start, epochs):
        with obs.span("lloyd.epoch", cat="lloyd", epoch=ep) as sp:
            map_reduce(store, map_fn, combine, None, prefetch=prefetch, emit=emit, device=dev)
            total = float(state[2])
            trajectory.append(total - seen_cost)
            seen_cost = total
            sp.set(inertia=trajectory[-1])
        if checkpoint_dir is not None:
            ckpt.save_lloyd_state(
                checkpoint_dir, step=ep + 1, centroids=cell[0], labels=labels.numpy(),
                trajectory=trajectory, shifts=[], changed=True, fingerprint=fp,
                devices_used=1, stats={"Z": state[0], "g": state[1], "seen_cost": state[2]},
            )

    inertia = _final_assign(store, coeffs, disc, cell, labels, prefetch, dev, pol)
    trajectory.append(inertia)
    return StreamLloydResult(  # +1 pass: the final assign streams everything again
        labels.numpy().copy(), cell[0], inertia, epochs, (epochs + 1) * store.n,
        tuple(trajectory), (),
    )


def stream_fit_predict(
    seed: int,
    store: BlockStore,
    kernel,
    k: int,
    cfg=None,
    *,
    mode: str = "exact",
    landmark_sample: int = 4096,
    decay: float = 0.9,
    epochs: int = 1,
    prefetch: int | None = None,
    device=None,
):
    """End-to-end embed-and-conquer over a block stream:

    1. reservoir-sample rows for landmark selection (one pass),
    2. fit the embedding on the sample (tiny and resident, as in the paper, P4.3),
    3. cluster the stream: exact out-of-core Lloyd (``mode="exact"``) or
       single-pass mini-batch (``"minibatch"``), the embedding fused into the
       per-block step (Y never materializes).

    ``seed`` splits three ways (``phase1_seeds``): which rows the reservoir
    keeps, the embedding fit's draws, and the clustering's k-means++ draws,
    so landmark selection is not correlated with the embedding's own
    randomness. ``cfg`` is a `core.kkmeans.APNCConfig`. Runs on ``device``
    (default: the card). Returns (StreamLloydResult, params).
    """
    from repro_torch.api.estimator import phase1_seeds
    from repro_torch.core import kkmeans

    cfg = cfg or kkmeans.APNCConfig()
    pol = cfg.compute
    dev = resolve_device(device)
    s_sample, s_fit, s_cluster = phase1_seeds(seed)
    sample = torch.from_numpy(reservoir_sample(store, landmark_sample, seed=s_sample)).to(
        dev, torch.float32)
    coeffs = kkmeans.fit_coefficients(s_fit, sample, kernel, cfg)
    common = dict(coeffs=coeffs, generator=torch.Generator().manual_seed(s_cluster),
                  policy=pol, prefetch=prefetch, device=dev)
    if mode == "exact":
        res = ooc_lloyd(store, k, iters=cfg.iters, **common)
    elif mode == "minibatch":
        res = minibatch_lloyd(store, k, decay=decay, epochs=epochs, **common)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return res, coeffs
