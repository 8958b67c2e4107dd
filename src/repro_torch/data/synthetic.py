"""Synthetic gaussian blobs, made one numpy block at a time.

A numpy copy of the JAX package's blocked generator: the same seed gives the
same rows and labels.
"""
from __future__ import annotations

import numpy as np


def gaussian_blobs_blocks(
    seed: int, n: int, d: int, k: int, *, block_rows: int,
    separation: float = 3.0, anisotropy: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """The blocked gaussian mixture, blocks concatenated: (X (n, d) f32,
    labels (n,) i32). Block i is drawn from ``default_rng((seed, i))``."""
    base = np.random.default_rng(seed)
    centers = (base.standard_normal((k, d)) * separation).astype(np.float32)
    scales = (1.0 + anisotropy * base.random((k, d))).astype(np.float32)
    Xs, ys = [], []
    for i in range(-(-n // block_rows)):
        rows = min(block_rows, n - i * block_rows)
        rng = np.random.default_rng((seed, i))
        labels = rng.integers(0, k, size=rows, dtype=np.int32)
        X = centers[labels] + rng.standard_normal((rows, d)).astype(np.float32) * scales[labels]
        Xs.append(X.astype(np.float32))
        ys.append(labels)
    return np.concatenate(Xs), np.concatenate(ys)
