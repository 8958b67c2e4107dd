"""Synthetic datasets.

The paper's benchmark datasets (Table 1) are not shipped, so they are
mirrored by generators with matched (n, d, k) and controlled difficulty:

  * a gaussian mixture with per-cluster anisotropic scales,
  * an optional nonlinear warp (so the RBF / poly / tanh kernels matter:
    linearly separable blobs would let vanilla k-means win and hide the
    differences between kernel approximations),
  * 'rings': concentric shells, the classic kernel-k-means-beats-k-means case.

`gaussian_blobs`, `rings` and `paper_standin` draw from a ``torch.Generator``
seeded with ``seed`` on the device they make the data on (the card unless
``device="cpu"``), so their draws are not the JAX package's; their arithmetic
is in `_blobs_from_draws` / `_rings_from_draws`, which tests feed the JAX
package's draws. The mixture's centers, scales and warp are drawn before the
labels and the noise, so they do not depend on n. The blocked generators
(`gaussian_blobs_blocks`, `rings_blocks`) are numpy copies of the JAX
package's: two generator-backed BlockStores (rows, labels) that make one
block at a time, the same seed giving the same rows and labels.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from repro_torch.configs.paper_datasets import PAPER_DATASETS, PaperDataset
from repro_torch.device import resolve_device

#: Rank of the warp above d = 2048, where a dense d x d rotation would be
#: gigabytes (RCV1's d = 47,236).
_WARP_RANK = 256


def _blobs_from_draws(centers: torch.Tensor, scales: torch.Tensor, labels: torch.Tensor,
                      noise: torch.Tensor, warp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixture from its draws: X = centers[labels] + noise * scales[labels],
    then, with ``warp`` (a (d, d) rotation R, or a (U, V) pair of rank
    256), tanh(X / 2) R + X / 10 (or (tanh(X / 2) U) V + X / 10). Returns
    (X (n, d) f32, labels (n,) int32)."""
    X = centers[labels] + noise * scales[labels]
    if warp is not None:
        # A mild elementwise nonlinearity and a random rotation mix the
        # geometry: euclidean k-means degrades, kernel methods keep the
        # structure.
        warped = torch.tanh(X * 0.5)
        if isinstance(warp, torch.Tensor):
            X = warped @ warp + 0.1 * X
        else:
            U, V = warp
            X = (warped @ U) @ V + 0.1 * X
    return X.to(torch.float32), labels.to(torch.int32)


def gaussian_blobs(
    seed: int, n: int, d: int, k: int, separation: float = 3.0,
    anisotropy: float = 0.5, warp: bool = False, *, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A gaussian mixture of k clusters in d dimensions, (X (n, d) f32,
    labels (n,) int32), made on ``device`` (default: the card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    centers = torch.randn((k, d), generator=g, device=dev) * separation
    scales = 1.0 + anisotropy * torch.rand((k, d), generator=g, device=dev)
    R = None
    if warp and d <= 2048:
        R = torch.randn((d, d), generator=g, device=dev) / math.sqrt(d)
    elif warp:
        R = (torch.randn((d, _WARP_RANK), generator=g, device=dev) / math.sqrt(d),
             torch.randn((_WARP_RANK, d), generator=g, device=dev) / math.sqrt(_WARP_RANK))
    labels = torch.randint(0, k, (n,), generator=g, device=dev)
    noise = torch.randn((n, d), generator=g, device=dev)
    return _blobs_from_draws(centers, scales, labels, noise, R)


def _rings_from_draws(labels: torch.Tensor, u: torch.Tensor, noise: torch.Tensor,
                      noise_scale: float, gap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rings from their draws: ring ``labels``, angles ``u`` in [0, 1) and
    (n, 2) standard normal ``noise``."""
    radius = 1.0 + gap * labels.to(torch.float32)
    theta = u * 2 * math.pi
    X = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta)], dim=1)
    X = X + noise_scale * noise
    return X.to(torch.float32), labels.to(torch.int32)


def rings(seed: int, n: int, k: int = 3, noise: float = 0.05, gap: float = 2.0, *,
          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Concentric 2-D shells, made on ``device`` (default: the card): k-means
    fails, kernel k-means (RBF) succeeds."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    labels = torch.randint(0, k, (n,), generator=g, device=dev)
    u = torch.rand((n,), generator=g, device=dev)
    eps = torch.randn((n, 2), generator=g, device=dev)
    return _rings_from_draws(labels, u, eps, noise, gap)


def _blocked_pair(make_block, n: int, d: int, block_rows: int):
    """Wrap a ``make_block(i) -> (X_block, y_block)`` generator as two
    BlockStores (features, labels) sharing a small per-block cache, so that
    reading X and then y of one block generates it once. The cache is
    locked: the sharded executors read one store from several threads, and
    an unlocked clear between another thread's insert and its read raised
    KeyError."""
    from repro_torch.stream.blockstore import BlockStore

    cache: dict[int, tuple] = {}
    lock = threading.Lock()

    def cached(i):
        with lock:
            block = cache.get(i)
        if block is None:
            block = make_block(i)
            with lock:
                if len(cache) > 2:  # keep at most a couple of blocks resident
                    cache.clear()
                cache[i] = block
        return block

    X_store = BlockStore.from_generator(
        lambda i: cached(i)[0], n=n, d=d, block_rows=block_rows
    )
    y_store = BlockStore.from_generator(
        lambda i: cached(i)[1].reshape(-1, 1), n=n, d=1, block_rows=block_rows,
        dtype=np.int32,
    )
    return X_store, y_store


def gaussian_blobs_blocks(
    seed: int, n: int, d: int, k: int, *, block_rows: int,
    separation: float = 3.0, anisotropy: float = 0.5, warp: bool = False,
):
    """Blocked gaussian mixture, one (block_rows, d) numpy block at a time: the
    host-side generator for out-of-core runs. Block i is drawn from
    ``default_rng((seed, i))``, so blocks can be re-requested across Lloyd
    iterations. ``warp`` applies `gaussian_blobs`' warp, dense up to d = 2048
    and of rank 256 above. Returns (X_store, labels_store)."""
    base = np.random.default_rng(seed)
    centers = (base.standard_normal((k, d)) * separation).astype(np.float32)
    scales = (1.0 + anisotropy * base.random((k, d))).astype(np.float32)
    if warp:
        if d <= 2048:
            W = (base.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
            UV = None
        else:
            UV = (
                (base.standard_normal((d, _WARP_RANK)) / np.sqrt(d)).astype(np.float32),
                (base.standard_normal((_WARP_RANK, d)) / np.sqrt(_WARP_RANK)).astype(np.float32),
            )

    def make_block(i: int):
        rows = min(block_rows, n - i * block_rows)
        rng = np.random.default_rng((seed, i))
        labels = rng.integers(0, k, size=rows, dtype=np.int32)
        X = centers[labels] + rng.standard_normal((rows, d)).astype(np.float32) * scales[labels]
        if warp:
            warped = np.tanh(X * 0.5)
            X = (warped @ W if UV is None else (warped @ UV[0]) @ UV[1]) + 0.1 * X
        return X.astype(np.float32), labels

    return _blocked_pair(make_block, n, d, block_rows)


def rings_blocks(
    seed: int, n: int, k: int = 3, *, block_rows: int, noise: float = 0.05,
    gap: float = 2.0,
):
    """Blocked `rings`: concentric 2-D shells, one block at a time, block i
    drawn from ``default_rng((seed, i))``. Returns (X_store, labels_store)."""

    def make_block(i: int):
        rows = min(block_rows, n - i * block_rows)
        rng = np.random.default_rng((seed, i))
        labels = rng.integers(0, k, size=rows, dtype=np.int32)
        radius = 1.0 + gap * labels.astype(np.float32)
        theta = rng.random(rows).astype(np.float32) * 2 * np.pi
        X = np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=1)
        X = X + noise * rng.standard_normal((rows, 2)).astype(np.float32)
        return X.astype(np.float32), labels

    return _blocked_pair(make_block, n, 2, block_rows)


def paper_standin(name: str, seed: int = 0, n_override: int = 0, *,
                  device=None) -> tuple[torch.Tensor, torch.Tensor, PaperDataset]:
    """Synthetic stand-in for a paper dataset: its (d, k) and separation, the
    warp on, at bench scale (``n_override``, else ``bench_n``, else n rows).
    Returns (X, labels, the dataset's config), made on ``device``."""
    ds = PAPER_DATASETS[name]
    n = n_override or ds.bench_n or ds.n
    X, y = gaussian_blobs(seed, n, ds.d, ds.k, separation=ds.separation, warp=True,
                          device=device)
    return X, y, ds
