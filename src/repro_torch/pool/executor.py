"""Per-device worker loops over a TaskPool: the worker half of the plane.

`pool_map_reduce(store, map_fns, devices=...)` runs one pass over every
block of ``store``: D worker threads (one per entry of ``devices``, entries
may repeat) pull leased block tasks from one shared `TaskPool`, read the
block from the host store (through the chaos harness, where injected faults
surface), copy it to their device through their own `Uploader` (a pinned
ring and a copy stream on a card), run their map on their own compute
stream, copy the small per-block output back to the host, and hand it to
the pool keyed by block id.

Against the lockstep executor (`repro_torch.stream.sharded
.sharded_map_reduce`), placement is only affinity: any worker runs any
block, dead workers' tasks are requeued, stragglers' unread blocks are
stolen and in-flight leases backed up, so the pass completes while one
worker survives. The price is that the partial statistics come back to the
host a block at a time; the payoff is determinism under faults: the caller
merges the outputs in global block-id order with host float32 sums, so the
result is bitwise the same whatever the schedule, the retries or the
injected chaos (the pool drops duplicates, and every execution of a block is
the same function of the same bits).
"""
from __future__ import annotations

import atexit
import contextlib
import threading
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch import obs
from repro_torch.launch.mesh import as_device
from repro_torch.pool import chaos
from repro_torch.pool.tasks import TaskPool
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.engine import Uploader, adopt, block_nbytes, count_pass, fetch_block
from repro_torch.stream.sharded import shard_names, shard_stream

# Workers whose pass already ended (their last block was re-executed
# elsewhere and they were still draining when the pass returned). Each exits
# within one block; `drain_stale` joins them so a fit's counts are final and
# no worker is inside a kernel call at interpreter teardown.
_stale_lock = threading.Lock()
_stale: list[threading.Thread] = []


def drain_stale(timeout: float = 10.0) -> None:
    """Join the stale workers of earlier passes (at most ``timeout`` s)."""
    with _stale_lock:
        threads, _stale[:] = list(_stale), []
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


atexit.register(drain_stale)


def _to_host(out):
    """A map's output, tensors copied to host numpy arrays (on a card the
    copy waits for the worker's stream)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(o) for o in out)
    return out


def _worker(pool: TaskPool, store: BlockStore, map_fn, worker: int, device: torch.device,
            name: str, emit: Callable[[int, Any], None] | None):
    obs.set_lane(f"worker:{name}")
    blocks = obs.counter("engine.blocks_read")
    dev_blocks = obs.counter(f"engine.device_blocks.{name}")
    nbytes = obs.counter("engine.bytes_h2d")
    dispatches = obs.counter("engine.map_dispatches")
    plan = chaos.active()
    on_card = device.type == "cuda"
    try:
        with contextlib.ExitStack() as stack:
            # A stale worker w of the previous pass may still be launching on
            # this stream; each kernel call holds the stream's scratch lock
            # (`kernels.lloyd_step.step_launch`), so their launches never
            # interleave inside one call.
            if on_card:
                stack.enter_context(torch.cuda.device(device))
                stack.enter_context(torch.cuda.stream(shard_stream(device, worker)))
            up = Uploader(device, 2)
            while True:
                task = pool.acquire(worker)
                if task is None:
                    return
                with obs.span("pool.lease", cat="pool", block=task, worker=worker):
                    if plan is not None:
                        plan.before_read(worker)
                    blk = fetch_block(store, task)
                    blocks.inc()
                    dev_blocks.inc()
                    nbytes.inc(block_nbytes(blk))
                    out = map_fn(adopt(*up.put(blk)))
                    dispatches.inc()
                    host = _to_host(out)
                if pool.complete(worker, task, host) and emit is not None:
                    emit(task, host)
    except BaseException as e:  # noqa: BLE001 - surfaced through pool.results()
        pool.fail_worker(worker, e)


def pool_map_reduce(
    store: BlockStore,
    map_fns: Sequence[Callable[[Any], Any]],
    *,
    devices: Sequence,
    lease_timeout: float = 60.0,
    emit: Callable[[int, Any], None] | None = None,
    label: str = "pool_pass",
) -> list[Any]:
    """One fault-tolerant pass of ``map_fns[w]`` over every block of ``store``.

    Returns the per-block outputs, as host numpy arrays, in GLOBAL block-id
    order: callers fold them with host float32 sums and get a
    schedule-independent result.

    ``emit(block_id, host_out)`` fires once per block, on the accepted (first)
    completion, from the completing worker's thread; duplicate re-executions
    never reach it. Worker w's producer lane and block counter are keyed by
    ``stream.sharded.shard_names(devices)[w]``.

    Raises the first worker error when the pass cannot complete (every
    worker died); a pass with one surviving worker always completes.
    """
    if len(map_fns) != len(devices):
        raise ValueError("need one map_fn per device")
    devices = [as_device(d) for d in devices]
    names = shard_names(devices)
    count_pass(label)
    pool = TaskPool(store.num_blocks, len(devices), lease_timeout=lease_timeout)
    for w, dev in enumerate(devices):  # the operands the maps read were made here
        if dev.type == "cuda":
            shard_stream(dev, w).wait_stream(torch.cuda.current_stream(dev))
    # The pass ends on the pool's completion, not on thread joins: a straggler
    # still inside a block that was re-executed elsewhere must not gate it.
    # Its late completion is a dropped duplicate and its thread exits at its
    # next acquire. Accepted emits are barriered, also after a worker died:
    # the driver reads the labels they write right after this returns.
    ecv = threading.Condition()
    emitted = [0]
    emit_errors: list[BaseException] = []

    def _emit(task_id, host):
        try:
            if emit is not None:
                emit(task_id, host)
        except BaseException as e:  # noqa: BLE001 - re-raised on the driver
            emit_errors.append(e)
        finally:
            with ecv:
                emitted[0] += 1
                ecv.notify_all()

    with obs.span(f"pass.{label}", cat="pass", blocks=store.num_blocks, workers=len(devices)):
        threads = [
            threading.Thread(target=_worker, name=f"pool-worker:{names[w]}",
                             args=(pool, store, fn, w, dev, names[w], _emit), daemon=True)
            for w, (fn, dev) in enumerate(zip(map_fns, devices))
        ]
        for t in threads:
            t.start()
        pool.wait()
        if pool.done:
            with ecv:
                while emitted[0] < store.num_blocks:
                    ecv.wait(timeout=0.05)
    with _stale_lock:
        _stale[:] = [t for t in _stale if t.is_alive()]
        _stale.extend(t for t in threads if t.is_alive())
    if emit_errors:
        raise emit_errors[0]
    return pool.results()

