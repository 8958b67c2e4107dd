"""Host-resident block store: a logical (n, d) row matrix cut into row blocks.

This slice needs only the resident-array view the estimator samples its
landmarks through. Codecs, memmaps and writable stores arrive with the stream
backend.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class BlockStore:
    """Fixed-size row blocks over a logical (n, d) matrix; ``get(i)`` returns
    block i as a numpy array of shape (rows_i, d), the last block ragged."""

    def __init__(
        self, get: Callable[[int], np.ndarray], *, n: int, d: int,
        block_rows: int, dtype=np.float32,
    ):
        if block_rows <= 0:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._get = get
        self.n = int(n)
        self.d = int(d)
        self.block_rows = int(block_rows)
        self.dtype = np.dtype(dtype)

    @property
    def num_blocks(self) -> int:
        return -(-self.n // self.block_rows)

    def rows_of(self, i: int) -> int:
        """Row count of block i (handles the ragged final block)."""
        return min(self.block_rows, self.n - i * self.block_rows)

    def row_offset(self, i: int) -> int:
        """Global row index of the first row of block i."""
        return i * self.block_rows

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_blocks:
            raise IndexError(f"block {i} out of range [0, {self.num_blocks})")
        blk = np.asarray(self._get(i))
        expect = (self.rows_of(i), self.d)
        if blk.shape != expect:
            raise ValueError(f"block {i}: backing returned {blk.shape}, want {expect}")
        return blk

    def materialize(self) -> np.ndarray:
        """Concatenate every block (small data only)."""
        return np.concatenate([self.get(i) for i in range(self.num_blocks)], axis=0)

    @classmethod
    def from_array(cls, X, block_rows: int) -> "BlockStore":
        """View a resident (n, d) array as blocks (zero-copy slices)."""
        X = np.asarray(X)
        n, d = X.shape
        return cls(
            lambda i: X[i * block_rows: (i + 1) * block_rows],
            n=n, d=d, block_rows=block_rows, dtype=X.dtype,
        )
