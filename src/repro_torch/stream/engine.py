"""MapReduce-style block executor with a pipelined host->device transfer.

`map_reduce(store, map_fn, combine_fn, init)` is the program shape of the
whole paper: an embarrassingly parallel map over row blocks and a small
associative combine. Embedding (Algorithm 1) and assignment (Algorithm 2's
map + in-mapper combiner) are its two map_fns.

Pipelining: a background producer thread pulls block i+1 from the store (the
host cost: generation, memmap page-in) and starts its copy to the card while
the card works on block i. On a card the copy runs on a dedicated
`torch.cuda.Stream`, from pinned host memory, so it overlaps compute:

  * a block that already lies in pinned memory (a store over a pinned array)
    is copied straight from it; any other block is first copied into a ring
    of `prefetch + 1` pinned staging buffers, and a buffer is reused only
    after the event of the copy that last read it has completed;
  * each device block carries the event recorded after its copy; the
    consumer's stream waits on that event before the map runs, and the block
    is marked as used by that stream (`record_stream`), so its memory is not
    handed out again before the map's kernels are done with it;
  * the producer thread runs under the consumer's device.

`prefetch=0` is the synchronous baseline: every block is fetched,
transferred, computed and waited on before the next block is touched.

A store staged under a compressed codec streams in its wire form
(`fetch_block` returns the `EncodedBlock`): payload and scale cross to the
card together, under one event, and the Lloyd step decodes them there.

Telemetry lives in `repro_torch.obs`, under the JAX package's names:
counters `engine.blocks_read`, `engine.bytes_h2d` (wire bytes for a
compressed store), `engine.device_blocks.<device>`, `engine.map_dispatches`,
`engine.passes.<label>` and `engine.prefetch_stall_s` (seconds the consumer
waited on an empty prefetch queue), `cache.bytes_staged` and the
`cache.compression_ratio` gauge of the last staged cache. With tracing on,
the producer thread records `block.get` and `h2d` spans on its lane
(`producer:<device>`), the consumer `stall.queue_empty` and one
`pass.<label>` span a pass. A span is host time: `h2d` times the enqueue
of the `non_blocking` copies on the copy stream, not the copies (as the
JAX package's times `jax.device_put`, which only starts one). `COUNTERS` and `PASS_COUNTS` are the older
module-level views of the same numbers, kept in lockstep; `reset_counters()`
zeroes all of them.

Device placement: ``device=`` maps every block onto one device, and
``name=`` keys its producer lane and per-device counter (default: the
device's name). The sharded executor (`repro_torch.stream.sharded`) runs one
`map_reduce` per shard, each on its own thread and CUDA stream, and names
each by shard where a mesh repeats a device, so that eight logical shards on
one ``cpu`` keep eight lanes and eight counters.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import on_device, resolve_device
from repro_torch.obs.metrics import MetricsView
from repro_torch.stream.blockstore import BlockStore, EncodedBlock, WritableBlockStore

_STOP = object()

_BLOCKS = obs.counter("engine.blocks_read")
_BYTES_H2D = obs.counter("engine.bytes_h2d")
_STALL_S = obs.counter("engine.prefetch_stall_s")
_DISPATCHES = obs.counter("engine.map_dispatches")
_BYTES_STAGED = obs.counter("cache.bytes_staged")
_RATIO = obs.gauge("cache.compression_ratio")

#: Engine passes recorded per label, kept in lockstep with the
#: `engine.passes.<label>` counters.
PASS_COUNTS: "collections.Counter[str]" = collections.Counter()
_PASS_LOCK = threading.Lock()
#: The engine counters under their older short names (a read-only view).
COUNTERS = MetricsView(
    blocks_read=(_BLOCKS, int), bytes_h2d=(_BYTES_H2D, int),
    prefetch_stall_s=(_STALL_S, float), map_dispatches=(_DISPATCHES, int),
    bytes_staged=(_BYTES_STAGED, int), compression_ratio=(_RATIO, float),
)


def count_pass(label: str) -> None:
    obs.counter(f"engine.passes.{label}").inc()
    with _PASS_LOCK:
        PASS_COUNTS[label] += 1


def pass_count(label: str) -> int:
    """Engine passes recorded under ``label`` since the last reset."""
    return int(obs.counter(f"engine.passes.{label}").value)


def reset_pass_counts() -> None:
    """Zero the engine-pass telemetry (measurement scoping)."""
    obs.reset_metrics("engine.passes.")
    with _PASS_LOCK:
        PASS_COUNTS.clear()


def reset_counters() -> None:
    """Zero the engine telemetry, pass counts included (measurement
    scoping)."""
    reset_pass_counts()
    obs.reset_metrics("engine.")
    obs.reset_metrics("cache.")


def device_name(device: torch.device) -> str:
    """``cuda:<index>`` for a card (the current one when unindexed), else
    the device's type: the producer lane's and per-device counter's key."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _count_block(blk, device_blocks: obs.Counter) -> None:
    _BLOCKS.inc()
    device_blocks.inc()
    _BYTES_H2D.inc(block_nbytes(blk))


def fetch_block(store: BlockStore, i: int) -> "np.ndarray | EncodedBlock":
    """The engine's one block-read seam (the synchronous path and the
    producer thread both read through here): the codec wire form for a store
    staged compressed, so the cheap bytes cross the link, else the block."""
    if store.codec != "f32":
        enc = store.get_encoded(i)
        if enc is not None:
            return enc
    return store.get(i)


def block_nbytes(blk) -> int:
    """Host -> device bytes of one fetched block (payload plus scale bytes for
    an `EncodedBlock`)."""
    if isinstance(blk, EncodedBlock):
        return int(blk.payload.nbytes + np.asarray(blk.scale).nbytes)
    return int(blk.nbytes)


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor, zero-copy; uint16 holds bf16 bits, which
    become a ``torch.bfloat16`` view."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Uploader:
    """Moves host blocks (arrays or `EncodedBlock`s) onto one device: on a
    card through its own copy stream and pinned memory, with one completion
    event per block; on the CPU as zero-copy tensors.

    The pinned staging ring holds raw bytes: each slot has one buffer per
    part of a block (the payload, and the scale of an encoded block), each
    grown only when a block needs more bytes, so blocks whose parts differ
    in type never reallocate pinned memory."""

    def __init__(self, device: torch.device, ring: int):
        self.device = device
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.staging: list[list[torch.Tensor | None]] = [[None, None] for _ in range(ring)]
            self.freed: list[torch.cuda.Event | None] = [None] * ring
            self.slot = 0

    def _stage(self, slot: int, part: int, host: torch.Tensor) -> torch.Tensor:
        nbytes = host.numel() * host.element_size()
        buf = self.staging[slot][part]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.staging[slot][part] = buf
        return buf[:nbytes].view(host.dtype).view(host.shape).copy_(host)

    def put(self, blk):
        """(device block, event recorded after its copies, or None on the
        CPU); the device block is a tensor, or an `EncodedBlock` of tensors."""
        encoded = isinstance(blk, EncodedBlock)
        parts = [host_tensor(blk.payload), host_tensor(np.asarray(blk.scale))] if encoded \
            else [host_tensor(blk)]
        if self.device.type != "cuda":
            devs, event = [p.to(self.device) for p in parts], None
        else:
            slot = None
            if not all(p.is_pinned() for p in parts):
                slot, self.slot = self.slot, (self.slot + 1) % len(self.staging)
                if self.freed[slot] is not None:
                    self.freed[slot].synchronize()  # the copies that last read it are done
                parts = [p if p.is_pinned() else self._stage(slot, j, p)
                         for j, p in enumerate(parts)]
            with torch.cuda.stream(self.stream):
                devs = [torch.empty(p.shape, dtype=p.dtype, device=self.device)
                        .copy_(p, non_blocking=True) for p in parts]
                event = torch.cuda.Event()
                event.record(self.stream)
            if slot is not None:
                self.freed[slot] = event
        return (EncodedBlock(*devs) if encoded else devs[0]), event


def adopt(dev, event):
    """Order the current stream after a block's copies and mark the block's
    tensors as used by it."""
    if event is not None:
        tensors = dev if isinstance(dev, EncodedBlock) else (dev,)
        stream = torch.cuda.current_stream(tensors[0].device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
    return dev


def _offer(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded-queue put that gives up once ``stop`` is set. Every
    producer-side put goes through here: an unconditional put on a full queue
    after ``close()`` has drained it once would block forever and deadlock the
    ``join()`` in ``close()``."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _producer(store: BlockStore, q: "queue.Queue", stop: threading.Event,
              device: torch.device, ring: int, lane: str) -> None:
    # One lane per producer thread: its spans render as this producer's row
    # of the trace, and its per-device block counter is a FitReport's
    # per_device_blocks.
    obs.set_lane(lane)
    device_blocks = obs.counter(f"engine.device_blocks.{lane.split(':', 1)[-1]}")
    try:
        with on_device(device):
            up = Uploader(device, ring)
            for i in range(store.num_blocks):
                if stop.is_set():
                    return
                with obs.span("block.get", cat="ingest", block=i):
                    blk = fetch_block(store, i)
                # Host time: the copy is queued on the copy stream, not waited for.
                with obs.span("h2d", cat="ingest", block=i):
                    dev, event = up.put(blk)
                _count_block(blk, device_blocks)
                if not _offer(q, (i, dev, event, None), stop):
                    return
        _offer(q, _STOP, stop)
    except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
        _offer(q, (None, None, None, e), stop)


class BlockPrefetcher:
    """Iterator of (local_i, device_block) over a store, in block order, with
    a background producer keeping a bounded queue of blocks whose copies to
    ``device`` are already under way. ``name`` keys the producer's lane
    (``producer:<name>``) and its ``engine.device_blocks.<name>`` counter
    (default: the device's name).

    Blocks are ordered on the stream that is current where the iterator is
    advanced (see `adopt`), so a shard thread iterates under its own stream.

    Always ``close()`` (or exhaust) the iterator: a dropped prefetcher would
    leave its producer thread blocked on the queue.
    """

    def __init__(self, store: BlockStore, *, prefetch: int = 2, device=None,
                 name: str | None = None):
        self.device = resolve_device(device)
        depth = max(1, prefetch)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self.lane = f"producer:{name or device_name(self.device)}"
        self._t = threading.Thread(
            target=_producer, name=f"block-{self.lane}",
            args=(store, self._q, self._stop, self.device, depth + 1, self.lane), daemon=True,
        )
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        # Time blocked on an empty queue is the ingest-bound signal: the
        # producer, not the device, held the pass up. Counted always; a span
        # only with tracing on.
        t0 = time.perf_counter()
        item = self._q.get()
        wait = time.perf_counter() - t0
        _STALL_S.inc(wait)
        if obs.TRACER.enabled and wait > 0:
            s = obs.Span(obs.TRACER, "stall.queue_empty", "stall",
                         obs.TRACER.current_lane(), {"producer": self.lane})
            s.t0, s.dur = t0, wait
            obs.TRACER._record(s)
        if item is _STOP:
            self._done = True
            raise StopIteration
        i, dev, event, err = item
        if err is not None:
            self._done = True
            raise err
        return i, adopt(dev, event)

    def close(self) -> None:
        """Stop and join the producer; safe to call more than once.

        Drain and join interleave in a loop: a producer that was blocked
        mid-put can enqueue one more item after a drain and refill the queue
        before the join. Its puts give up once the stop flag is set, so this
        converges.
        """
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)
        while True:  # release queued device blocks promptly
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._done = True


def map_reduce(
    store: BlockStore,
    map_fn: Callable[[torch.Tensor], Any],
    combine_fn: Callable[[Any, Any], Any],
    init: Any,
    *,
    prefetch: int = 2,
    emit: Callable[[int, Any], None] | None = None,
    device=None,
    label: str = "map_reduce",
    name: str | None = None,
) -> Any:
    """Fold ``combine_fn(acc, map_fn(block))`` over every block of ``store``.

    map_fn runs on ``device`` (default: the card; ``"cpu"`` for the plain
    path); combine_fn must be associative enough that per-block accumulation
    matches the monolithic computation (sums, counts, min/max: the paper's
    (Z, g) case). ``emit(i, out)``, when given, receives each block's map
    output before the combine, on the consumer thread in block order.

    prefetch: depth of the producer queue; 0 is the synchronous baseline.
    label: each call adds one pass to ``engine.passes.<label>``.
    name: the key of the producer lane and the per-device block counter
    (default: the device's name).
    """
    dev = resolve_device(device)
    count_pass(label)
    acc = init
    with obs.span(f"pass.{label}", cat="pass", blocks=store.num_blocks, prefetch=prefetch):
        if prefetch <= 0:
            with on_device(dev):
                device_blocks = obs.counter(f"engine.device_blocks.{name or device_name(dev)}")
                up = Uploader(dev, 1)
                for i in range(store.num_blocks):
                    blk = fetch_block(store, i)
                    _count_block(blk, device_blocks)
                    out = map_fn(adopt(*up.put(blk)))
                    _DISPATCHES.inc()
                    if emit is not None:
                        emit(i, out)
                    acc = combine_fn(acc, out)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            return acc

        pf = BlockPrefetcher(store, prefetch=prefetch, device=dev, name=name)
        try:
            for i, blk in pf:
                out = map_fn(blk)
                _DISPATCHES.inc()
                if emit is not None:
                    emit(i, out)
                acc = combine_fn(acc, out)
        finally:
            pf.close()
    return acc


def cache_embedding(
    store: BlockStore,
    map_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    d_out: int,
    out: WritableBlockStore | None = None,
    codec: str = "f32",
    prefetch: int = 2,
    device=None,
    label: str = "cache_embedding",
    name: str | None = None,
) -> WritableBlockStore:
    """Materialize ``map_fn`` over every block of ``store`` into a staged host
    store, through the same pipelined prefetcher as any other pass: the
    embed-once pass of the sweep. Blocks are written by global block id, so
    a shard's local block i lands at its global offset, and staged under
    ``codec`` ("f32" | "bf16" | "int8", the policy's ``cache_dtype``).
    The ``cache.bytes_staged`` counter grows by each block's wire size and
    the ``cache.compression_ratio`` gauge is set to f32 bytes over staged
    bytes.
    The returned ``WritableBlockStore`` raises on any read of a block this
    pass never produced. ``out=`` lets the D passes of a sharded embedding
    (disjoint round-robin block subsets) fill one shared store; by default a
    new one is made."""
    if out is None:
        out = BlockStore.empty(n=store.n, d=d_out, block_rows=store.block_rows, codec=codec)

    def emit(i, y):
        gid = store.block_id(i)
        out.put(gid, y.cpu().numpy())
        _BYTES_STAGED.inc(out.staged_nbytes(gid))

    map_reduce(store, map_fn, lambda acc, _: acc, None, prefetch=prefetch, emit=emit,
               device=device, label=label, name=name)
    _RATIO.set(out.n * out.d * 4 / max(out.nbytes_staged, 1))
    return out
