"""Host-resident block store: the HDFS-block analogue of the paper's setting.

A `BlockStore` is a logical (n, d) row matrix cut into fixed-size row blocks
(the last block may be ragged). Blocks are produced on demand as numpy arrays:
from a resident array, from a generator function (synthetic data made one
block at a time instead of the full matrix), or from a memory-mapped file on
disk, so nothing larger than one block has to exist on the host unless the
backing itself is resident.

Stores compose: `shard(i, s)` restricts a store to a round-robin subset of
blocks (how a data axis of several devices would split the stream), and
`empty(...)` + `put(...)` give a writable store for staged outputs (e.g. the
embedded Y blocks of Algorithm 1).

The JAX package also stages blocks in compressed codecs ("bf16", "int8").
This port stages plain f32 only: any other `codec` raises
`NotImplementedError`, as `ComputePolicy(cache_dtype=...)` does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator

import numpy as np


def _check_codec(codec: str) -> None:
    if codec not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown cache codec {codec!r}: expected 'f32', 'bf16' or 'int8'")
    if codec != "f32":
        raise NotImplementedError(
            f"codec={codec!r} is not ported yet; it arrives with the sweep and "
            "quantized-cache slice (see ROADMAP.md)"
        )


class BlockStore:
    """Fixed-size row blocks over a logical (n, d) matrix.

    `get(i)` returns block i as a numpy array of shape (rows_i, d) where
    rows_i == block_rows except possibly for the final block.
    """

    def __init__(
        self,
        get: Callable[[int], np.ndarray],
        *,
        n: int,
        d: int,
        block_rows: int,
        dtype=np.float32,
        block_ids: tuple[int, ...] | None = None,
    ):
        if block_rows <= 0:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._get = get
        self.n = int(n)
        self.d = int(d)
        self.block_rows = int(block_rows)
        self.dtype = np.dtype(dtype)
        total = -(-self.n // self.block_rows)
        self._block_ids = tuple(range(total)) if block_ids is None else tuple(block_ids)

    # -- shape / iteration --------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self._block_ids)

    def rows_of(self, i: int) -> int:
        """Row count of local block i (handles the ragged final block)."""
        gid = self._block_ids[i]
        return min(self.block_rows, self.n - gid * self.block_rows)

    def block_id(self, i: int) -> int:
        """Global block id of local block i (differs after shard())."""
        return self._block_ids[i]

    def row_offset(self, i: int) -> int:
        """Global row index of the first row of local block i."""
        return self._block_ids[i] * self.block_rows

    def _read(self, gid: int) -> np.ndarray:
        """Backing read by global block id. Derived stores (`shard`,
        `map_rows`) close over the parent's bound `_read`, so a subclass that
        guards reads (WritableBlockStore's unwritten-block check) keeps its
        guard in every derived view."""
        return np.asarray(self._get(gid))

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_blocks:
            raise IndexError(f"block {i} out of range [0, {self.num_blocks})")
        blk = self._read(self._block_ids[i])
        expect = (self.rows_of(i), self.d)
        if blk.shape != expect:
            raise ValueError(f"block {i}: backing returned {blk.shape}, want {expect}")
        return blk

    def __iter__(self) -> Iterator[np.ndarray]:
        return (self.get(i) for i in range(self.num_blocks))

    def __len__(self) -> int:
        return self.num_blocks

    # -- composition --------------------------------------------------------

    def shard(self, index: int, num_shards: int) -> "BlockStore":
        """Round-robin block subset for worker `index` of `num_shards`."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range for {num_shards}")
        return BlockStore(
            self._read, n=self.n, d=self.d, block_rows=self.block_rows,
            dtype=self.dtype, block_ids=self._block_ids[index::num_shards],
        )

    def map_rows(self, fn: Callable[[np.ndarray], np.ndarray], d_out: int) -> "BlockStore":
        """Lazy per-block host transform (e.g. column select); same blocking."""
        return BlockStore(
            lambda gid: np.asarray(fn(self._read(gid))),
            n=self.n, d=d_out, block_rows=self.block_rows,
            dtype=self.dtype, block_ids=self._block_ids,
        )

    def materialize(self) -> np.ndarray:
        """Concatenate every block (tests and small data only)."""
        return np.concatenate([self.get(i) for i in range(self.num_blocks)], axis=0)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_array(cls, X, block_rows: int) -> "BlockStore":
        """View a resident (n, d) array as blocks (zero-copy slices)."""
        X = np.asarray(X)
        n, d = X.shape
        return cls(
            lambda i: X[i * block_rows: (i + 1) * block_rows],
            n=n, d=d, block_rows=block_rows, dtype=X.dtype,
        )

    @classmethod
    def from_generator(
        cls, make_block: Callable[[int], np.ndarray], *,
        n: int, d: int, block_rows: int, dtype=np.float32,
    ) -> "BlockStore":
        """Blocks produced on demand by `make_block(block_id)`; the function
        must be deterministic per id (blocks are re-requested across Lloyd
        iterations)."""
        return cls(make_block, n=n, d=d, block_rows=block_rows, dtype=dtype)

    @classmethod
    def from_memmap(
        cls, path: str | Path, *, d: int, block_rows: int, dtype=np.float32,
        codec: str = "f32",
    ) -> "BlockStore":
        """Blocks read from a flat row-major binary file through np.memmap: the
        page cache is the only resident state."""
        _check_codec(codec)
        path = Path(path)
        itemsize = np.dtype(dtype).itemsize
        size = path.stat().st_size
        ragged = size % (d * itemsize)
        if ragged:
            raise ValueError(
                f"{path}: size {size} bytes is not a multiple of "
                f"d * itemsize = {d} * {itemsize}; {ragged} ragged trailing "
                "bytes (truncated file, or wrong d/dtype?)"
            )
        n = size // (d * itemsize)
        mm = np.memmap(path, dtype=dtype, mode="r", shape=(n, d))
        return cls(
            lambda i: np.asarray(mm[i * block_rows: (i + 1) * block_rows]),
            n=n, d=d, block_rows=block_rows, dtype=dtype,
        )

    @classmethod
    def empty(
        cls, *, n: int, d: int, block_rows: int, dtype=np.float32, codec: str = "f32",
    ) -> "WritableBlockStore":
        """Writable store backed by one preallocated host array (staging area
        for per-block outputs, e.g. embedded Y blocks or label vectors)."""
        return WritableBlockStore(n=n, d=d, block_rows=block_rows, dtype=dtype, codec=codec)


class WritableBlockStore(BlockStore):
    """A BlockStore whose blocks are filled by `put(i, block)`.

    The unwritten-block guard sits on the global-id read seam, so every
    shard() / map_rows() view raises on a block this store never staged
    instead of reading zeros.
    """

    def __init__(self, *, n: int, d: int, block_rows: int, dtype=np.float32,
                 codec: str = "f32"):
        _check_codec(codec)
        self._buf = np.zeros((n, d), dtype=dtype)
        self._filled = np.zeros(-(-n // block_rows), dtype=bool)
        super().__init__(
            lambda i: self._buf[i * block_rows: (i + 1) * block_rows],
            n=n, d=d, block_rows=block_rows, dtype=dtype,
        )

    def put(self, i: int, block: np.ndarray) -> None:
        lo = i * self.block_rows
        hi = lo + min(self.block_rows, self.n - lo)
        block = np.asarray(block)
        if block.shape != (hi - lo, self.d):
            raise ValueError(f"put block {i}: got {block.shape}, want {(hi - lo, self.d)}")
        self._buf[lo:hi] = block
        self._filled[i] = True

    def _read(self, gid: int) -> np.ndarray:
        if not self._filled[gid]:
            raise ValueError(f"block {gid} read before it was written")
        return super()._read(gid)
