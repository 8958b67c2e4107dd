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

Staged stores can hold their blocks in a compressed wire form: a
`CacheCodec` ("f32" passthrough, "bf16", per-column-scaled symmetric "int8")
encodes each block on `put` and decodes on `get`, so every consumer that
reads `get` keeps seeing f32, while the codec-aware ones (the stream engine's
producer, the Lloyd step plan) move the `EncodedBlock` wire form to the card
and decode it inside the kernel. Both read paths sit on the global-id
`_read*` seam, so the unwritten-block guard protects them equally.

bf16 payloads are held as `np.uint16` bit patterns (numpy has no bfloat16
type of its own): the top half of the f32 bits, rounded to nearest even,
bit for bit what `ml_dtypes.bfloat16` gives.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch


class EncodedBlock(NamedTuple):
    """One staged block in its codec's wire form.

    ``payload`` is the (rows, d) array in the codec's storage type (int8, or
    the uint16 bits of bf16 on the host; int8 or ``torch.bfloat16`` once on
    the card), ``scale`` the dequantization factor: a (1, d) f32 row of
    per-column scales for int8, the scalar 1.0 for bf16. The stream engine
    moves both to the card, and the Lloyd step plan decodes
    ``payload * scale`` there: the decoded f32 block never crosses the
    host -> device link.
    """

    payload: "np.ndarray | torch.Tensor"
    scale: "np.ndarray | torch.Tensor"


class BlockHeader(NamedTuple):
    """Typed per-block metadata of a staged store: how block bytes decode."""

    codec: str  # "f32" | "bf16" | "int8"
    rows: int  # row count of this block (ragged final block < block_rows)
    d: int  # feature width
    scale: float  # largest dequant factor of the block (1.0 for f32/bf16)


def bf16_bits(block: np.ndarray) -> np.ndarray:
    """f32 -> the uint16 bits of bf16, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(block, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """The uint16 bits of bf16 -> f32, exactly (the bits are the top half)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


class CacheCodec:
    """One staged-cache codec: f32 block <-> (payload, scale) wire form.

    The error bounds are the contract:

      f32   passthrough; exact.
      bf16  elementwise relative error <= 2**-8 (bf16 keeps 8 significand
            bits); scale is identically 1.0.
      int8  per-column symmetric: scale_j = max|col_j| / 127 (clamped
            >= 1e-12) in f32, q = clip(rint(block / scale), -127, 127). The
            rounding error is at most scale_j / 2, so elementwise
            |y - q * scale| <= max|col| / 254: every feature keeps about
            0.4 % relative accuracy however its range compares to the
            others' (embedded Y columns are eigenvalue-scaled).
    """

    def __init__(self, name: str, store_dtype):
        if name not in CODECS:
            raise ValueError(
                f"unknown cache codec {name!r}: expected 'f32', 'bf16' or 'int8'"
            )
        self.name = name
        self.store_dtype = np.dtype(store_dtype)

    def encode(self, block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """f32 block -> (payload in store_dtype, dequant scale: a (1, d)
        per-column row for int8, the scalar 1.0 otherwise)."""
        if self.name == "f32":
            return block, np.float32(1.0)
        if self.name == "bf16":
            return bf16_bits(block), np.float32(1.0)
        scale = np.maximum(
            np.max(np.abs(block), axis=0, keepdims=True) / 127.0, 1e-12
        ).astype(np.float32)
        q = np.clip(np.rint(block / scale), -127, 127).astype(np.int8)
        return q, scale

    def decode(self, payload: np.ndarray, scale) -> np.ndarray:
        """(payload, scale) -> the decoded f32 block (identity for f32)."""
        if self.name == "f32":
            return payload
        if self.name == "bf16":
            return bf16_to_f32(payload)
        return payload.astype(np.float32) * np.asarray(scale, np.float32)

    def error_bound(self, block: np.ndarray) -> np.ndarray:
        """Elementwise bound on |decode(encode(block)) - block| (the contract
        above), as an array broadcastable to ``block``."""
        if self.name == "f32":
            return np.zeros_like(block)
        if self.name == "bf16":
            return np.abs(block) * np.float32(2.0 ** -8)
        amax = np.max(np.abs(block), axis=0, keepdims=True)
        return np.broadcast_to(
            np.maximum(amax / 254.0, 1e-12), block.shape
        ).astype(np.float32)


CODECS = ("f32", "bf16", "int8")


def get_codec(name: str) -> CacheCodec:
    """The `CacheCodec` registered under ``name`` ("f32" | "bf16" | "int8")."""
    if name == "f32":
        return CacheCodec("f32", np.float32)
    if name == "bf16":
        return CacheCodec("bf16", np.uint16)
    if name == "int8":
        return CacheCodec("int8", np.int8)
    raise ValueError(f"unknown cache codec {name!r}: expected one of {CODECS}")


class BlockStore:
    """Fixed-size row blocks over a logical (n, d) matrix.

    `get(i)` returns block i as a numpy array of shape (rows_i, d) where
    rows_i == block_rows except possibly for the final block. A store staged
    under a compressed codec also serves `get_encoded(i)`, the block's wire
    form.
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
        codec: str = "f32",
        get_encoded: "Callable[[int], EncodedBlock] | None" = None,
    ):
        if block_rows <= 0:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._get = get
        self.n = int(n)
        self.d = int(d)
        self.block_rows = int(block_rows)
        self.dtype = np.dtype(dtype)  # the logical type: what get() decodes to
        #: Storage codec of the backing ("f32" | "bf16" | "int8"); get()
        #: always decodes, get_encoded() gives the wire form.
        self.codec = str(codec)
        self._get_encoded = get_encoded
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

    def _read_encoded(self, gid: int) -> EncodedBlock | None:
        """Wire-form read by global block id: the codec payload and scale, or
        None when the store has no encoded backing (codec "f32", or an f32
        derived view). On the same seam as `_read`, so a guarded subclass
        guards both paths and `shard()` views inherit both."""
        if self._get_encoded is None:
            return None
        return self._get_encoded(gid)

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_blocks:
            raise IndexError(f"block {i} out of range [0, {self.num_blocks})")
        blk = self._read(self._block_ids[i])
        expect = (self.rows_of(i), self.d)
        if blk.shape != expect:
            raise ValueError(f"block {i}: backing returned {blk.shape}, want {expect}")
        return blk

    def get_encoded(self, i: int) -> EncodedBlock | None:
        """Local block i in its codec's wire form (no decode, no f32 copy), or
        None when the store stages plain f32."""
        if not 0 <= i < self.num_blocks:
            raise IndexError(f"block {i} out of range [0, {self.num_blocks})")
        return self._read_encoded(self._block_ids[i])

    def header(self, i: int) -> BlockHeader:
        """Typed header of local block i: codec, shape and the block's
        largest dequant factor."""
        enc = self.get_encoded(i)
        scale = float(np.max(enc.scale)) if enc is not None else 1.0
        return BlockHeader(codec=self.codec, rows=self.rows_of(i), d=self.d, scale=scale)

    def __iter__(self) -> Iterator[np.ndarray]:
        return (self.get(i) for i in range(self.num_blocks))

    def __len__(self) -> int:
        return self.num_blocks

    # -- composition --------------------------------------------------------

    def shard(self, index: int, num_shards: int) -> "BlockStore":
        """Round-robin block subset for worker `index` of `num_shards`."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range for {num_shards}")
        # Both read seams pass on as bound methods, so a guarded parent keeps
        # guarding, and a codec parent keeps serving wire-form reads.
        return BlockStore(
            self._read, n=self.n, d=self.d, block_rows=self.block_rows,
            dtype=self.dtype, block_ids=self._block_ids[index::num_shards],
            codec=self.codec, get_encoded=self._read_encoded,
        )

    def map_rows(self, fn: Callable[[np.ndarray], np.ndarray], d_out: int) -> "BlockStore":
        """Lazy per-block host transform (e.g. column select); same blocking.
        ``fn`` sees decoded f32 blocks, so the view is a plain f32 store."""
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
        codec: str = "f32", scales=None,
    ) -> "BlockStore":
        """Blocks read from a flat row-major binary file through np.memmap: the
        page cache is the only resident state.

        ``codec=`` reads a compressed staged cache back: the file holds the
        codec's storage type (int8, or the uint16 bits of bf16) and
        ``scales`` the (num_blocks, d) per-block, per-column dequant rows
        (required for "int8", ignored for "bf16", whose scale is 1.0). Reads
        decode to f32; `get_encoded` serves the wire form off the memmap."""
        path = Path(path)
        codec_obj = get_codec(codec)
        store_dtype = codec_obj.store_dtype if codec != "f32" else np.dtype(dtype)
        itemsize = store_dtype.itemsize
        size = path.stat().st_size
        ragged = size % (d * itemsize)
        if ragged:
            raise ValueError(
                f"{path}: size {size} bytes is not a multiple of "
                f"d * itemsize = {d} * {itemsize}; {ragged} ragged trailing "
                "bytes (truncated file, or wrong d/dtype/codec?)"
            )
        n = size // (d * itemsize)
        mm = np.memmap(path, dtype=store_dtype, mode="r", shape=(n, d))
        if codec == "f32":
            return cls(
                lambda i: np.asarray(mm[i * block_rows: (i + 1) * block_rows]),
                n=n, d=d, block_rows=block_rows, dtype=dtype,
            )
        num_blocks = -(-n // block_rows)
        if codec == "int8" and scales is None:
            raise ValueError(f"{path}: codec 'int8' needs per-column scales=")
        sc = (np.ones((num_blocks, d), np.float32) if scales is None
              else np.asarray(scales, np.float32))
        if sc.shape != (num_blocks, d):
            raise ValueError(
                f"{path}: scales shape {np.shape(scales)} does not match "
                f"({num_blocks}, {d})"
            )

        def _enc(i: int) -> EncodedBlock:
            payload = np.asarray(mm[i * block_rows: (i + 1) * block_rows])
            if codec == "bf16":
                return EncodedBlock(payload, np.float32(1.0))
            return EncodedBlock(payload, sc[i:i + 1])

        return cls(
            lambda i: codec_obj.decode(
                np.asarray(mm[i * block_rows: (i + 1) * block_rows]), sc[i:i + 1]),
            n=n, d=d, block_rows=block_rows, dtype=dtype, codec=codec,
            get_encoded=_enc,
        )

    @classmethod
    def empty(
        cls, *, n: int, d: int, block_rows: int, dtype=np.float32, codec: str = "f32",
    ) -> "WritableBlockStore":
        """Writable store backed by one preallocated host array (staging area
        for per-block outputs, e.g. embedded Y blocks or label vectors).
        ``codec=`` stages the blocks compressed."""
        return WritableBlockStore(n=n, d=d, block_rows=block_rows, dtype=dtype, codec=codec)


class WritableBlockStore(BlockStore):
    """A BlockStore whose blocks are filled by `put(i, block)`.

    With a compressed ``codec``, `put` encodes the f32 block into the staging
    buffer's wire form (int8 or bf16 bits, plus the block's scale row) and
    `get` decodes it back to f32, within the codec's error bound.
    `get_encoded` reads the wire form without decoding. The unwritten-block
    guard sits on the global-id read seam, so both read paths, and every
    shard() / map_rows() view, raise on a block this store never staged
    instead of reading zeros.
    """

    def __init__(self, *, n: int, d: int, block_rows: int, dtype=np.float32,
                 codec: str = "f32"):
        self._cache_codec = get_codec(codec)
        buf_dtype = self._cache_codec.store_dtype if codec != "f32" else np.dtype(dtype)
        self._buf = np.zeros((n, d), dtype=buf_dtype)
        num_blocks = -(-n // block_rows)
        self._filled = np.zeros(num_blocks, dtype=bool)
        # per-block, per-column dequant rows (int8); all ones for f32 / bf16
        self._scales = np.ones((num_blocks, d), dtype=np.float32)
        super().__init__(
            lambda i: self._cache_codec.decode(
                self._buf[i * block_rows: (i + 1) * block_rows], self._scales[i:i + 1]),
            n=n, d=d, block_rows=block_rows, dtype=dtype, codec=codec,
        )

    def put(self, i: int, block: np.ndarray) -> None:
        lo = i * self.block_rows
        hi = lo + min(self.block_rows, self.n - lo)
        block = np.asarray(block)
        if block.shape != (hi - lo, self.d):
            raise ValueError(f"put block {i}: got {block.shape}, want {(hi - lo, self.d)}")
        payload, scale = self._cache_codec.encode(block)
        self._buf[lo:hi] = payload
        self._scales[i] = scale  # the scalar 1.0 broadcasts for f32 / bf16
        self._filled[i] = True

    def _read(self, gid: int) -> np.ndarray:
        if not self._filled[gid]:
            raise ValueError(f"block {gid} read before it was written")
        return super()._read(gid)

    def _read_encoded(self, gid: int) -> EncodedBlock | None:
        if self.codec == "f32":
            return None
        if not self._filled[gid]:  # the same guard as the decoded path
            raise ValueError(f"block {gid} read before it was written")
        lo = gid * self.block_rows
        hi = lo + min(self.block_rows, self.n - lo)
        if self.codec == "bf16":  # the scale is 1.0: no row to ship
            return EncodedBlock(self._buf[lo:hi], np.float32(1.0))
        return EncodedBlock(self._buf[lo:hi], self._scales[gid:gid + 1])

    def staged_nbytes(self, gid: int) -> int:
        """Bytes block ``gid`` occupies in the staging buffer (its wire size,
        with its per-column scale row for int8)."""
        rows = min(self.block_rows, self.n - gid * self.block_rows)
        extra = self.d * self._scales.itemsize if self.codec == "int8" else 0
        return rows * self.d * self._buf.itemsize + extra

    @property
    def nbytes_staged(self) -> int:
        """Total bytes of the staging buffer (with the scale rows for int8)."""
        extra = self._scales.nbytes if self.codec == "int8" else 0
        return self._buf.nbytes + extra
