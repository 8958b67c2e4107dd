"""Reservoir sampling over a block stream (Vitter's Algorithm R, block form).

A numpy copy of the JAX package's sampler: the same store and seed give the
same rows. The draws never read the data, only the block row counts, so
`reservoir_rows` makes them alone and returns which row each slot keeps;
`reservoir_sample` gathers those rows from a store's blocks, and a caller
holding the whole array gathers them wherever the array lives.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from repro_torch.stream.blockstore import BlockStore


def block_row_counts(n: int, block_rows: int) -> list[int]:
    """Row counts of ``BlockStore.from_array(X, block_rows)``'s blocks for an
    n-row X: full blocks, then the ragged last one."""
    return [min(block_rows, n - start) for start in range(0, n, block_rows)]


def reservoir_rows(block_rows: Sequence[int], size: int, *, seed: int = 0) -> np.ndarray:
    """The draws of `reservoir_sample` over blocks of these row counts: the
    int64 row index (over the blocks in order) that each of the
    ``min(size, sum(block_rows))`` slots keeps, in slot order."""
    rng = np.random.default_rng(seed)
    rows_of_slot = np.arange(min(size, sum(block_rows)), dtype=np.int64)
    seen = 0
    for rows in block_rows:
        # fill phase: the first `size` rows go straight into their own slots
        take = min(max(size - seen, 0), rows)
        # replace phase: row t (0-based global) enters with prob size/(t+1)
        t = np.arange(seen + take, seen + rows)
        accept = rng.random(rows - take) < size / (t + 1)
        idx = np.nonzero(accept)[0]
        if idx.size:
            slots = rng.integers(0, size, size=idx.size)
            # later rows must overwrite earlier ones landing in the same slot:
            # numpy's fancy assignment keeps the last write of a repeated slot
            rows_of_slot[slots] = t[idx]
        seen += rows
    return rows_of_slot


def reservoir_sample(store: BlockStore, size: int, *, seed: int = 0) -> np.ndarray:
    """One pass over `store`; returns (min(size, n), d) rows, uniformly without
    replacement over all rows seen. Deterministic given seed."""
    rows = reservoir_rows([store.rows_of(b) for b in range(store.num_blocks)], size,
                          seed=seed)
    reservoir = np.zeros((min(size, store.n), store.d), dtype=store.dtype)
    # slots by row, so that each block fills its slots from one slice
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    start = 0
    for b in range(store.num_blocks):
        blk = store.get(b)
        end = start + blk.shape[0]
        lo, hi = np.searchsorted(sorted_rows, (start, end))
        reservoir[order[lo:hi]] = blk[sorted_rows[lo:hi] - start]
        start = end
    return reservoir
