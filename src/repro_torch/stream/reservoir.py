"""Reservoir sampling over a block stream (Vitter's Algorithm R, block form).

A numpy copy of the JAX package's sampler: the same store and seed give the
same rows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.stream.blockstore import BlockStore


def reservoir_sample(store: BlockStore, size: int, *, seed: int = 0) -> np.ndarray:
    """One pass over `store`; returns (min(size, n), d) rows, uniformly without
    replacement over all rows seen. Deterministic given seed."""
    rng = np.random.default_rng(seed)
    reservoir = np.zeros((min(size, store.n), store.d), dtype=store.dtype)
    seen = 0
    for b in range(store.num_blocks):
        blk = store.get(b)
        rows = blk.shape[0]
        take = min(max(size - seen, 0), rows)
        if take:  # fill phase: first `size` rows go straight in
            reservoir[seen:seen + take] = blk[:take]
        # replace phase: row t (0-based global) enters with prob size/(t+1)
        t = np.arange(seen + take, seen + rows)
        accept = rng.random(rows - take) < size / (t + 1)
        idx = np.nonzero(accept)[0]
        if idx.size:
            slots = rng.integers(0, size, size=idx.size)
            # later rows must overwrite earlier ones landing in the same slot
            reservoir[slots] = blk[take + idx]
        seen += rows
    return reservoir
