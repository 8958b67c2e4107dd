"""Fused Lloyd steps, embed or decode + assign + (Z, g, cost) in one launch: hand-written CUDA kernels.

Replaces ``src/repro/kernels/lloyd_step.py::fused_apnc_step``,
``::fused_rff_step`` and ``::fused_dequant_step``, the Pallas TPU kernels. The
sources are ``csrc/lloyd_step.cu`` (the two embedding steps) and
``csrc/dequant_step.cu`` (the step over a quantized cache block), both ending
in the epilogue of ``csrc/lloyd_epilogue.cuh``; their headers hold the bound
on an H100 and what the design does about it (operation-bound; one CTA embeds
or decodes a tile of 32 rows into a shared-memory tile that the assign
epilogue reads in place, so Y never reaches device memory and a 4,096-row
block is 128 CTAs; (Z, g, cost) go through per-CTA partials summed in a fixed
order, so they are bitwise deterministic).

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes the same function with the plain PyTorch version.
``launches`` counts kernel launches per kernel, and nothing else; traced, a
call on a card is a ``launch.<kernel>`` span (``build.launch_span``).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    dequant_ref,
    fused_apnc_step_ref,
    fused_dequant_step_ref,
    fused_rff_step_ref,
)

#: Kernel launches so far, per kernel (CUDA tensors only). ``dequant_decode``
#: is the decode kernel of the route above ``DEQUANT_MAX_M``.
launches = {"fused_apnc_step": 0, "fused_rff_step": 0, "fused_dequant_step": 0,
            "dequant_decode": 0}


def _count(name: str) -> None:
    """Count one launch of kernel ``name``; under a lock, since launches come
    from several threads (the serving tier's dispatcher, a swap's warm-up)."""
    with build.LAUNCH_LOCK:
        launches[name] += 1


#: Largest embedding width (rff: 2 * m_half) one launch takes: the
#: (tile rows x m) Y tile lives in shared memory. ``csrc/lloyd_step.cu``
#: holds the same bound.
MAX_M = 512

#: Largest m one ``fused_dequant_step`` launch takes: its decoded (32 x m) Y
#: tile, the epilogue's C buffers (the raw payload tile in their space), the
#: scales and scratch are 194,308 bytes at m = 800, and a CTA may have 232,448.
#: ``csrc/dequant_step.cu`` holds the same bound.
DEQUANT_MAX_M = 800

#: Upper bound on the CTAs of one launch, and so on the (k, m) partials held
#: in scratch. It depends on nothing but itself, so the order of the final
#: sums, and with them every bit of (Z, g, cost), is the same on every run.
MAX_CTAS = 264

#: Rows per CTA tile of each fused step: ``lloyd_step_tile_rows(0)`` and
#: ``(1)`` in ``csrc/lloyd_step.cu``, ``dequant_step_tile_rows()`` in
#: ``csrc/dequant_step.cu``; the libraries are checked against it on load.
TILE_ROWS = {"apnc": 32, "rff": 32, "dequant": 32}

_KINDS = {"rbf": 0, "poly": 1, "tanh": 2, "linear": 3}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _configure_dequant(lib: ctypes.CDLL) -> None:
    lib.fused_dequant_step.argtypes = [_P, _I] + [_P] * 9 + [_I] * 6 + [_P]
    lib.dequant_decode.argtypes = [_P, _I, _P, _P, ctypes.c_longlong, _I, _P]
    for fn in (lib.fused_dequant_step, lib.dequant_decode, lib.dequant_step_max_m,
               lib.dequant_step_tile_rows):
        fn.restype = ctypes.c_int
    for fn in (lib.dequant_step_max_m, lib.dequant_step_tile_rows):
        fn.argtypes = []
    lib.fused_dequant_smem_bytes.argtypes = [_I, _I]
    lib.fused_dequant_smem_bytes.restype = ctypes.c_longlong
    if (lib.dequant_step_max_m() != DEQUANT_MAX_M
            or lib.dequant_step_tile_rows() != TILE_ROWS["dequant"]):
        raise RuntimeError(
            "dequant_step.cu and lloyd_step.py disagree on DEQUANT_MAX_M or TILE_ROWS")


def _configure_steps(lib: ctypes.CDLL) -> None:
    lib.fused_apnc_step_f32.argtypes = [_P] * 11 + [_I] * 9 + [_F, _F, _F, _I, _P]
    lib.fused_rff_step_f32.argtypes = [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P]
    for fn in (lib.fused_apnc_step_f32, lib.fused_rff_step_f32, lib.lloyd_step_max_m,
               lib.lloyd_step_tile_rows):
        fn.restype = ctypes.c_int
    lib.lloyd_step_max_m.argtypes = []
    lib.lloyd_step_tile_rows.argtypes = [_I]
    for fn in (lib.fused_apnc_smem_bytes, lib.fused_rff_smem_bytes):
        fn.argtypes = [_I]
        fn.restype = ctypes.c_longlong
    if (lib.lloyd_step_max_m() != MAX_M or lib.lloyd_step_tile_rows(0) != TILE_ROWS["apnc"]
            or lib.lloyd_step_tile_rows(1) != TILE_ROWS["rff"]):
        raise RuntimeError("lloyd_step.cu and lloyd_step.py disagree on MAX_M or TILE_ROWS")


def _dequant_lib() -> ctypes.CDLL:
    return build.configured("dequant_step", _configure_dequant)


def _lib() -> ctypes.CDLL:
    return build.configured("lloyd_step", _configure_steps)


def smem_bytes(member: str, m: int) -> int:
    """Dynamic shared memory of one CTA of the fused launch for ``member``
    ("apnc" | "rff" | "dequant") at embedding width m; for "dequant", its
    bf16 instance's (its raw tile holds 2 bytes a value)."""
    if member == "dequant":
        return int(_dequant_lib().fused_dequant_smem_bytes(m, 1))
    lib = _lib()
    fn = lib.fused_apnc_smem_bytes if member == "apnc" else lib.fused_rff_smem_bytes
    return int(fn(m))


def _check(named: dict, discrepancy: str, device: torch.device | None = None) -> None:
    if discrepancy not in ("l2", "l1"):
        raise ValueError(f"unknown discrepancy {discrepancy!r}")
    dev = device if device is not None else named["X"].device
    for name, t in named.items():
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if named["C"].shape[0] == 0:
        raise ValueError("a Lloyd step needs at least one centroid")


class Geometry(NamedTuple):
    """How one fused launch covers n rows: CTA p takes the row tiles
    [p * tiles_per_cta, (p + 1) * tiles_per_cta) of ``n_tiles``, and keeps
    its (k, m) Z partial, (k,) count partial and cost partial in scratch."""

    n_tiles: int
    num_ctas: int
    tiles_per_cta: int

    def scratch_shapes(self, k: int, m: int) -> tuple[tuple, tuple, tuple]:
        """Shapes of the Zp, gp and costp scratch."""
        return (self.num_ctas, k, m), (self.num_ctas, k), (self.num_ctas,)


def launch_geometry(n: int, tile_rows: int) -> Geometry:
    """The CTAs of a fused launch over n rows in tiles of ``tile_rows``: at
    most ``MAX_CTAS``, each over an equal run of whole tiles (the last
    shorter), so the order of the final sums depends on n alone."""
    n_tiles = -(-n // tile_rows)
    tiles_per_cta = -(-n_tiles // max(1, min(n_tiles, MAX_CTAS)))
    return Geometry(n_tiles, -(-n_tiles // max(1, tiles_per_cta)), tiles_per_cta)


#: The per-CTA (Z, g, cost) partials of the fused launches and of
#: ``apnc_assign``: one buffer per (device, stream), grown as needed and kept.
#: Allocated a launch, the
#: 21.5 MB of a 4,096-row block at k = 164, m = 256 made a pass of 309
#: launches read 28-271 ms event-timed against 15-21 ms with this buffer, its
#: device time 11 ms either way (chip_smoke.py timing, NVIDIA H100 80GB HBM3,
#: 700.00 W).
#:
#: One C call enqueues two kernels on its stream: the main kernel writes the
#: partials, the reduce kernel sums them. The stream orders kernels, not the
#: pair, so two host threads on one stream (a pool worker still inside a
#: block that was re-executed elsewhere, and the next pass's worker of the
#: same shard) could enqueue A.main, B.main, A.reduce, B.reduce, and A would
#: sum B's partials. `step_launch` therefore holds the buffer's lock from its
#: get-then-grow until the call has enqueued both kernels.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}
_SCRATCH_LOCKS: dict[tuple[int, int], threading.Lock] = {}
_SCRATCH_LOCKS_GUARD = threading.Lock()


@contextlib.contextmanager
def step_launch(n: int, k: int, m: int, dev: torch.device, tile_rows: int,
                max_m: int | None = MAX_M):
    """Under the lock of the current stream's scratch, yields the outputs
    (Z, g, labels, cost) of one launch, the pointers the C entry takes for
    them and for the per-CTA scratch (its three parts by offset in
    ``_SCRATCH``), the launch's CTA count and tiles per CTA, and the stream it
    launches on. The caller makes its C call inside the block. ``max_m``: the
    widest m the kernel's tile takes (None: any)."""
    if max_m is not None and m > max_m:
        raise NotImplementedError(
            f"the fused Lloyd step holds a ({tile_rows} x m) Y tile in shared memory and "
            f"takes m <= {max_m}, got m={m}; the ops layer routes wider blocks "
            f"to the un-fused kernels"
        )
    out = (torch.empty((k, m), dtype=torch.float32, device=dev),
           torch.empty((k,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((), dtype=torch.float32, device=dev))
    if n == 0:  # no launch: the sums over no rows
        for t in (out[0], out[1], out[3]):
            t.zero_()
    geo = launch_geometry(n, tile_rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    need = sum(math.prod(shape) for shape in geo.scratch_shapes(k, m))
    with _SCRATCH_LOCKS_GUARD:
        lock = _SCRATCH_LOCKS.setdefault(key, threading.Lock())
    with lock:
        scratch = _SCRATCH.get(key)
        if scratch is None or scratch.numel() < need:
            scratch = _SCRATCH[key] = torch.empty((need,), dtype=torch.float32, device=dev)
        Zp = scratch.data_ptr()
        gp = Zp + 4 * geo.num_ctas * k * m
        Z, g, labels, cost = out
        ptrs = [Z.data_ptr(), g.data_ptr(), cost.data_ptr(), labels.data_ptr(),
                Zp, gp, gp + 4 * geo.num_ctas * k]
        yield out, ptrs, geo.num_ctas, geo.tiles_per_cta, stream


@build.launch_span("fused_apnc_step")
def fused_apnc_step(
    X: torch.Tensor, landmarks: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
    kernel: Kernel, discrepancy: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd block step of a q = 1 APNC member in one launch: X (n, d),
    landmarks (l, d), R (m, l), C (k, m) f32 -> Z (k, m) f32, g (k,) f32,
    labels (n,) int32, cost () f32 (sum of min e, sqrt'd for l2)."""
    _check(dict(X=X, landmarks=landmarks, R=R, C=C), discrepancy)
    n, d = X.shape
    l, m, k = landmarks.shape[0], R.shape[0], C.shape[0]
    if landmarks.shape[1] != d or R.shape[1] != l or C.shape[1] != m:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, landmarks {tuple(landmarks.shape)}, "
            f"R {tuple(R.shape)}, C {tuple(C.shape)}"
        )
    if X.device.type == "cpu":
        return fused_apnc_step_ref(X, landmarks, R, C, kernel, discrepancy)
    if X.device.type != "cuda":
        raise ValueError(f"fused_apnc_step runs on cuda or cpu, not {X.device}")
    if kernel.name not in _KINDS:
        raise ValueError(f"unknown kernel {kernel.name!r}")
    with step_launch(n, k, m, X.device, TILE_ROWS["apnc"]) as (
            out, ptrs, num_ctas, tiles_per_cta, stream):
        if n == 0:
            return out
        err = _lib().fused_apnc_step_f32(
            X.data_ptr(), landmarks.data_ptr(), R.data_ptr(), C.data_ptr(), *ptrs,
            n, d, l, m, k, int(discrepancy == "l1"), num_ctas, tiles_per_cta,
            _KINDS[kernel.name], float(kernel.gamma), float(kernel.coef0),
            float(kernel.scale), int(kernel.degree), stream,
        )
    build.check(err, "fused_apnc_step launch")
    _count("fused_apnc_step")
    return out


@build.launch_span("fused_rff_step")
def fused_rff_step(
    X: torch.Tensor, W: torch.Tensor, C: torch.Tensor, scale: float, discrepancy: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd block step of the rff member in one launch: X (n, d),
    W (d, m_half), C (k, 2 m_half) f32 in the [cos | sin] layout -> as
    ``fused_apnc_step``, with Y = scale [cos(X W), sin(X W)]."""
    _check(dict(X=X, W=W, C=C), discrepancy)
    n, d = X.shape
    mh, k = W.shape[1], C.shape[0]
    if W.shape[0] != d or C.shape[1] != 2 * mh:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, W {tuple(W.shape)}, C {tuple(C.shape)}"
        )
    if X.device.type == "cpu":
        return fused_rff_step_ref(X, W, C, scale, discrepancy)
    if X.device.type != "cuda":
        raise ValueError(f"fused_rff_step runs on cuda or cpu, not {X.device}")
    with step_launch(n, k, 2 * mh, X.device, TILE_ROWS["rff"]) as (
            out, ptrs, num_ctas, tiles_per_cta, stream):
        if n == 0:
            return out
        err = _lib().fused_rff_step_f32(
            X.data_ptr(), W.data_ptr(), C.data_ptr(), *ptrs,
            n, d, mh, k, int(discrepancy == "l1"), float(scale), num_ctas, tiles_per_cta,
            stream,
        )
    build.check(err, "fused_rff_step launch")
    _count("fused_rff_step")
    return out


def _check_encoded(Yq: torch.Tensor, scale: torch.Tensor) -> None:
    if Yq.ndim != 2:
        raise ValueError(f"Yq must be 2-D, got {tuple(Yq.shape)}")
    if Yq.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"Yq must be int8 or bfloat16, got {Yq.dtype}")
    if not Yq.is_contiguous():
        raise ValueError("Yq must be contiguous")
    if scale.dtype != torch.float32 or scale.device != Yq.device:
        raise TypeError(f"scale must be float32 on {Yq.device}, got {scale.dtype} on "
                        f"{scale.device}")
    want = 1 if Yq.dtype == torch.bfloat16 else Yq.shape[1]
    if scale.numel() != want:
        raise ValueError(f"scale of a {Yq.dtype} block must hold {want} values "
                         f"(int8: one per column; bf16: the codec's 1.0), got "
                         f"{tuple(scale.shape)}")


def _scale_row(Yq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor | None:
    """The m scales the kernels read for int8, contiguous; None for bf16,
    whose codec scale is identically 1.0 and is not read."""
    if Yq.dtype == torch.bfloat16:
        return None
    return scale if scale.is_contiguous() else scale.contiguous()


@build.launch_span("fused_dequant_step")
def fused_dequant_step(
    Yq: torch.Tensor, scale: torch.Tensor, C: torch.Tensor, discrepancy: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd step over a quantized cache block in one launch: Yq (n, m)
    int8 or bfloat16, scale (1, m) f32 for int8 or the codec's scalar 1.0 for
    bf16, C (k, m) f32 -> Z (k, m) f32, g (k,) f32, labels (n,) int32,
    cost () f32 (sum of min e, sqrt'd for l2), with Y = Yq * scale decoded in
    shared memory. Takes m <= ``DEQUANT_MAX_M`` on a card."""
    _check_encoded(Yq, scale)
    _check(dict(C=C), discrepancy, Yq.device)
    n, m = Yq.shape
    k = C.shape[0]
    if C.shape[1] != m:
        raise ValueError(f"shape mismatch: Yq {tuple(Yq.shape)}, C {tuple(C.shape)}")
    if Yq.device.type == "cpu":
        return fused_dequant_step_ref(Yq, scale, C, discrepancy)
    if Yq.device.type != "cuda":
        raise ValueError(f"fused_dequant_step runs on cuda or cpu, not {Yq.device}")
    row = _scale_row(Yq, scale)
    with step_launch(n, k, m, Yq.device, TILE_ROWS["dequant"], DEQUANT_MAX_M) as (
            out, ptrs, num_ctas, tiles_per_cta, stream):
        if n == 0:
            return out
        err = _dequant_lib().fused_dequant_step(
            Yq.data_ptr(), int(row is None), None if row is None else row.data_ptr(),
            C.data_ptr(), *ptrs,
            n, m, k, int(discrepancy == "l1"), num_ctas, tiles_per_cta, stream,
        )
    build.check(err, "fused_dequant_step launch")
    _count("fused_dequant_step")
    return out


@build.launch_span("dequant_decode")
def dequant_decode(Yq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode a quantized cache block into device memory, Y = Yq * scale
    (n, m) f32, with the same arithmetic as ``fused_dequant_step``: the
    first half of the route for blocks wider than ``DEQUANT_MAX_M``."""
    _check_encoded(Yq, scale)
    if Yq.device.type == "cpu":
        return dequant_ref(Yq, scale)
    if Yq.device.type != "cuda":
        raise ValueError(f"dequant_decode runs on cuda or cpu, not {Yq.device}")
    n, m = Yq.shape
    Y = torch.empty((n, m), dtype=torch.float32, device=Yq.device)
    if Y.numel() == 0:
        return Y
    row = _scale_row(Yq, scale)
    err = _dequant_lib().dequant_decode(
        Yq.data_ptr(), int(row is None), None if row is None else row.data_ptr(),
        Y.data_ptr(), Y.numel(), m,
        torch.cuda.current_stream(Yq.device).cuda_stream,
    )
    build.check(err, "dequant_decode launch")
    _count("dequant_decode")
    return Y
