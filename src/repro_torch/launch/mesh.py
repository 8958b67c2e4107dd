"""Device meshes of the port: a named grid of `torch.device`s.

A `Mesh` is what the sharded backends (`stream_shard`, `shard_map`) map row
shards onto: one shard per coordinate of its data axes (every axis but
``"model"``). It is a plain description, built by a function and never at
import: ``make_mesh`` over the visible cards in order, or over an explicit
device list in which entries may repeat. Eight entries of ``cpu`` are the
counterpart of the eight host devices that the JAX package's tests force
with ``--xla_force_host_platform_device_count=8``; two entries of ``cuda:0``
are two logical shards on one card, each with its own producer and CUDA
stream. The JAX package's 16 x 16 TPU pod mesh (``make_production_mesh``)
has no counterpart here.

Below the drivers that use a mesh (`core.distributed`, `stream.sharded`, the
sweep), this module also holds what they share across its devices:
`shard_devices` (a mesh's data-axis devices) and the shuffle,
`cross_device_sum` and `replicate`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device

_REDUCTIONS = obs.counter("reduce.cross_device")

_WATCHERS: list = []


@contextlib.contextmanager
def watch_transfers(fn):
    """Within the block, ``fn(kind, nbytes, shards)`` is called for each
    cross-device transfer a sharded step makes, whatever the devices (a mesh
    of ``meta`` devices moves no bytes, and the dry-run counts them this
    way): ``("all-reduce", s, n)`` for a `cross_device_sum` of n shards of s
    bytes each, ``("all-gather", s, 1)`` for s bytes that
    `distributed.sharding.Sharded.take` reads from blocks its coordinate
    does not hold."""
    _WATCHERS.append(fn)
    try:
        yield
    finally:
        _WATCHERS.remove(fn)


def note_transfer(kind: str, nbytes: int, shards: int) -> None:
    for fn in _WATCHERS:
        fn(kind, nbytes, shards)


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(t) for t in tree)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with named axes.

    Attributes:
        devices: object ndarray of ``torch.device``, one entry per coordinate.
        axis_names: one name per axis of ``devices``.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def as_device(device) -> torch.device:
    """``cuda`` resolved to the current card's index; other devices as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    Args:
        shape: the size of each axis.
        axes: the name of each axis (``"model"`` carries no rows).
        devices: ``None`` for the visible cards in order (raises when there
            are fewer than ``prod(shape)``; never the CPU), or a sequence of
            exactly ``prod(shape)`` devices, repeats allowed.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    need = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"a {shape} mesh needs {need} CUDA cards and {have} are visible; pass "
                "devices= (entries may repeat, e.g. ['cpu'] * 8) for another layout")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = [as_device(d) for d in devices]
    if len(devices) != need:
        raise ValueError(f"a {shape} mesh takes {need} devices, got {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_host_mesh(data: int = 4, model: int = 2, device="cpu") -> Mesh:
    """A (data, model) mesh whose every entry is ``device`` (tests, examples)."""
    return make_mesh((data, model), ("data", "model"), devices=[device] * (data * model))


def shard_devices(mesh=None, *, device=None) -> list[torch.device]:
    """The devices a sharded run maps row or block shards onto, one per
    coordinate of the mesh's data axes (the ``model`` axis carries no rows,
    as in `core.distributed.data_axes_of`). Without a mesh: ``[cpu]`` when
    ``device`` is the CPU, else every visible card (the default device
    rule: none raises)."""
    if mesh is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    grid = np.asarray(mesh.devices, dtype=object)
    for ax in reversed(range(grid.ndim)):
        if mesh.axis_names[ax] == "model":
            grid = np.take(grid, 0, axis=ax)
    return [as_device(d) for d in np.asarray(grid, dtype=object).ravel()]


# ------------------------------------------------------------- the shuffle


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    raise TypeError(f"cannot map over {type(first).__name__}")


def replicate(t: torch.Tensor, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``t`` on every device of the list, in order (the broadcast of the small
    reducer state; a shard on ``t``'s own device gets ``t`` itself)."""
    return [t.to(dev, non_blocking=True) for dev in devices]


def cross_device_sum(accs: Sequence, devices: Sequence) -> Any:
    """The shuffle: the per-shard statistics (nested tuples / lists of
    tensors, each on its shard's device) summed leaf by leaf on
    ``devices[0]``, in shard order, where the drivers update the centroids
    once and `replicate` them. One shard returns ``accs[0]`` untouched.
    Every call with more than one shard is one ``reduce.cross_device`` count
    and span: one per synchronised Lloyd iteration, none in an embedding
    pass."""
    if len(devices) == 1:
        return accs[0]
    dev0 = as_device(devices[0])
    if _WATCHERS:
        note_transfer("all-reduce", _nbytes(accs[0]), len(devices))
    with obs.span("reduce.cross_device", cat="reduce", devices=len(devices)):
        _REDUCTIONS.inc()
        total = _tree_map(lambda t: t.to(dev0, non_blocking=True), accs[0])
        for acc in accs[1:]:
            total = _tree_map(lambda a, b: a + b.to(dev0, non_blocking=True), total, acc)
        return total
