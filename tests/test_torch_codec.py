"""The port's staged-cache codecs against the JAX package's: int8 payloads
and scales and bf16 payload bits equal bit for bit (the port holds bf16 as
uint16 bits without ml_dtypes), decode and error bounds equal, the memmap
round trip, the unwritten-block guard on both read paths, and the engine
moving the wire form and counting its bytes. Everything runs on the CPU."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.stream import blockstore as jbs
from repro.stream.engine import block_nbytes as j_block_nbytes
from repro_torch.stream import blockstore as tbs
from repro_torch.stream import engine

CPU = torch.device("cpu")


def _blocks():
    """Blocks that reach the codecs' edges: ragged rows, a zero column (the
    int8 scale clamp), wide dynamic range, exact rounding midpoints."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((37, 11)).astype(np.float32) * 3.0
    a[:, 4] = 0.0
    b = (rng.standard_normal((64, 5)) * np.logspace(-6, 6, 5)).astype(np.float32)
    # bf16 midpoints: the low 16 bits are exactly 0x8000, both parities.
    c = ((np.arange(0x3F00, 0x3F28, dtype=np.uint32).reshape(8, 5) << 16) | 0x8000).view(
        np.float32)
    return [a, b, np.ascontiguousarray(c), np.float32([[1e-30, -2.5e38, 65504.0]])]


@pytest.mark.parametrize("case", range(4))
def test_int8_payload_and_scale_equal_jax(case):
    block = _blocks()[case]
    q, s = tbs.get_codec("int8").encode(block)
    qj, sj = jbs.get_codec("int8").encode(block)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (1, block.shape[1])
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)


@pytest.mark.parametrize("case", range(4))
def test_bf16_bits_equal_ml_dtypes(case):
    block = _blocks()[case]
    bits, s = tbs.get_codec("bf16").encode(block)
    ref, sj = jbs.get_codec("bf16").encode(block)
    assert bits.dtype == np.uint16 and float(s) == float(sj) == 1.0
    np.testing.assert_array_equal(bits, ref.view(np.uint16))
    np.testing.assert_array_equal(bits, block.astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", range(3))
def test_decode_and_error_bound_equal_jax(codec, case):
    block = _blocks()[case]
    t, j = tbs.get_codec(codec), jbs.get_codec(codec)
    pt, st = t.encode(block)
    pj, sj = j.encode(block)
    dec = t.decode(pt, st)
    np.testing.assert_array_equal(dec, j.decode(pj, sj))
    np.testing.assert_array_equal(t.error_bound(block), j.error_bound(block))
    assert np.all(np.abs(dec - block) <= t.error_bound(block))


def _staged_pair(codec, X, block_rows):
    t = tbs.BlockStore.empty(n=X.shape[0], d=X.shape[1], block_rows=block_rows, codec=codec)
    j = jbs.BlockStore.empty(n=X.shape[0], d=X.shape[1], block_rows=block_rows, codec=codec)
    for i in range(t.num_blocks):
        blk = X[i * block_rows:(i + 1) * block_rows]
        t.put(i, blk)
        j.put(i, blk)
    return t, j


def _payload(enc):
    p = np.asarray(enc.payload)
    return p.view(np.uint16) if p.dtype == ml_dtypes.bfloat16 else p


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_writable_store_matches_jax(codec):
    X = np.random.default_rng(1).standard_normal((230, 9)).astype(np.float32)
    t, j = _staged_pair(codec, X, 64)
    assert t.nbytes_staged == j.nbytes_staged
    for i in range(t.num_blocks):
        np.testing.assert_array_equal(t.get(i), j.get(i))
        assert t.staged_nbytes(i) == j.staged_nbytes(i)
        assert t.header(i) == tuple(j.header(i))
        et, ej = t.get_encoded(i), j.get_encoded(i)
        if codec == "f32":
            assert et is None and ej is None
            continue
        np.testing.assert_array_equal(et.payload, _payload(ej))
        np.testing.assert_array_equal(np.asarray(et.scale), np.asarray(ej.scale))
    for s in range(2):  # shard views keep the codec and the wire form
        vt, vj = t.shard(s, 2), j.shard(s, 2)
        assert vt.codec == codec
        for i in range(vt.num_blocks):
            np.testing.assert_array_equal(vt.get(i), vj.get(i))
            if codec != "f32":
                np.testing.assert_array_equal(vt.get_encoded(i).payload,
                                              _payload(vj.get_encoded(i)))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_memmap_round_trip_with_scales(codec, tmp_path):
    X = np.random.default_rng(2).standard_normal((150, 6)).astype(np.float32) * 2.0
    t, j = _staged_pair(codec, X, 64)
    path = tmp_path / "y.bin"
    t._buf.tofile(path)
    scales = t._scales
    mt = tbs.BlockStore.from_memmap(path, d=6, block_rows=64, codec=codec, scales=scales)
    mj = jbs.BlockStore.from_memmap(path, d=6, block_rows=64, codec=codec, scales=scales)
    assert (mt.n, mt.num_blocks, mt.codec) == (150, 3, codec)
    for i in range(mt.num_blocks):
        np.testing.assert_array_equal(mt.get(i), t.get(i))
        np.testing.assert_array_equal(mt.get(i), mj.get(i))
        np.testing.assert_array_equal(mt.get_encoded(i).payload, t.get_encoded(i).payload)
        np.testing.assert_array_equal(np.asarray(mt.get_encoded(i).scale),
                                      np.asarray(t.get_encoded(i).scale))
    if codec == "int8":
        with pytest.raises(ValueError, match="scales="):
            tbs.BlockStore.from_memmap(path, d=6, block_rows=64, codec=codec)
    with pytest.raises(ValueError, match="does not match"):
        tbs.BlockStore.from_memmap(path, d=6, block_rows=64, codec=codec, scales=scales[:2])


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_unwritten_guard_covers_both_read_paths(codec):
    ws = tbs.BlockStore.empty(n=64, d=4, block_rows=16, codec=codec)
    ws.put(0, np.ones((16, 4), np.float32))
    with pytest.raises(ValueError, match="before it was written"):
        ws.get(2)
    if codec != "f32":
        with pytest.raises(ValueError, match="before it was written"):
            ws.get_encoded(2)
    view = ws.shard(0, 2)  # local block 1 is global block 2, unwritten
    with pytest.raises(ValueError, match="before it was written"):
        view.get(1)
    if codec != "f32":
        with pytest.raises(ValueError, match="before it was written"):
            view.get_encoded(1)
    with pytest.raises(ValueError, match="unknown cache codec"):
        tbs.get_codec("fp4")


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_engine_moves_the_wire_form(codec, prefetch):
    """A compressed store crosses as its EncodedBlock: bytes_h2d counts the
    payload and scale bytes as the JAX engine's block_nbytes does."""
    n, m, bn = 1000, 12, 256
    X = np.random.default_rng(3).standard_normal((n, m)).astype(np.float32)
    t, j = _staged_pair(codec, X, bn)
    nb = t.num_blocks
    seen = []
    engine.reset_counters()
    engine.map_reduce(t, lambda b: b, lambda acc, b: acc, None, prefetch=prefetch,
                      device=CPU, emit=lambda i, b: seen.append(b))
    want = {"f32": 4 * n * m, "bf16": 2 * n * m + 4 * nb, "int8": n * m + 4 * m * nb}[codec]
    assert engine.COUNTERS["bytes_h2d"] == want
    assert want == sum(j_block_nbytes(jbs_fetch(j, i)) for i in range(nb))
    for i, b in enumerate(seen):
        if codec == "f32":
            assert isinstance(b, torch.Tensor)
            continue
        assert isinstance(b, tbs.EncodedBlock)
        assert b.payload.dtype == (torch.int8 if codec == "int8" else torch.bfloat16)
        dec = b.payload.to(torch.float32) * b.scale
        np.testing.assert_array_equal(dec.numpy(), t.get(i))


def jbs_fetch(store, i):
    from repro.stream.engine import fetch_block

    return fetch_block(store, i)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_cache_embedding_counts_staged_bytes(codec):
    X = np.random.default_rng(4).standard_normal((300, 8)).astype(np.float32)
    store = tbs.BlockStore.from_array(X, 128)
    engine.reset_counters()
    out = engine.cache_embedding(store, lambda x: x * 2.0, d_out=8, codec=codec, device=CPU)
    assert out.codec == codec
    assert engine.COUNTERS["bytes_staged"] == out.nbytes_staged
    assert engine.COUNTERS["compression_ratio"] == pytest.approx(
        300 * 8 * 4 / out.nbytes_staged)
    bound = np.concatenate([tbs.get_codec(codec).error_bound(X[i:i + 128] * 2.0)
                            for i in range(0, 300, 128)])
    assert np.all(np.abs(out.materialize() - X * 2.0) <= bound)
