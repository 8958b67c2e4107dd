"""Fused APNC assignment, distances -> argmin -> (Z, g, cost): a hand-written CUDA kernel.

Replaces ``src/repro/kernels/apnc_assign.py::apnc_assign_padded``, the Pallas
TPU kernel, and the second pass over Y that the block's cost took
(``core.lloyd.block_cost``). The source is ``csrc/apnc_assign.cu``; its header
holds the bound on an H100 and what the design does about it
(operation-bound: 2*n*k*m f32 operations). Up to m = ``MAX_M`` it is the
fused steps' epilogue (``csrc/lloyd_epilogue.cuh``) on Y tiles read from
device memory, under the fused steps' launch geometry, so for the same Y its
(Z, g, labels, cost) are bit for bit those of ``fused_apnc_step``,
``fused_rff_step`` and ``fused_dequant_step``; wider m streams Y through
shared memory, with the same labels and cost. Either way the per-CTA partials
are summed in a fixed order, so every output is bitwise the same run to run.

``apnc_assign`` and ``apnc_assign_step`` launch the kernel for CUDA tensors
and raise if they cannot; for CPU tensors they compute the same function with
the plain PyTorch versions. ``launches`` counts kernel launches, and nothing
else, and the registry counter ``launch.apnc_assign.l1`` counts those under
l1; traced, a call on a card is a ``launch.apnc_assign`` span
(``build.launch_scope``, attrs ``rows`` and ``discrepancy``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build, lloyd_step
from repro_torch.kernels.ref import apnc_assign_ref, apnc_assign_step_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0


def _count() -> None:
    """Count one launch; under a lock, since launches come from several
    threads (the serving tier's dispatcher, a swap's warm-up)."""
    global launches
    with build.LAUNCH_LOCK:
        launches += 1


#: Largest m of the tiled kernel: its (32 x m) Y tile, the epilogue's C
#: buffers (the raw rows in their space) and scratch are 228,996 bytes at
#: m = 832, and a CTA may have 232,448. ``csrc/apnc_assign.cu`` holds the same
#: bound; wider m takes the streamed kernel.
MAX_M = 832

#: Rows per tile of the tiled kernel (the fused steps' tiles, so the same
#: launch geometry and the same bits) and of the streamed kernel above
#: ``MAX_M``; the library is checked against both on load.
TILE_ROWS = lloyd_step.TILE_ROWS["apnc"]
WIDE_TILE_ROWS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    lib.apnc_assign_f32.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.apnc_assign_f32.restype = ctypes.c_int
    lib.apnc_assign_max_m.argtypes = []
    lib.apnc_assign_tile_rows.argtypes = [_I]
    lib.apnc_assign_ctas_per_sm.argtypes = [_I, _I]
    for fn in (lib.apnc_assign_max_m, lib.apnc_assign_tile_rows, lib.apnc_assign_ctas_per_sm):
        fn.restype = ctypes.c_int
    lib.apnc_assign_smem_bytes.argtypes = [_I, _I]
    lib.apnc_assign_smem_bytes.restype = ctypes.c_longlong
    if (lib.apnc_assign_max_m() != MAX_M or lib.apnc_assign_tile_rows(0) != TILE_ROWS
            or lib.apnc_assign_tile_rows(1) != WIDE_TILE_ROWS):
        raise RuntimeError("apnc_assign.cu and apnc_assign.py disagree on MAX_M or TILE_ROWS")


def _lib() -> ctypes.CDLL:
    return build.configured("apnc_assign", _configure)


def smem_bytes(m: int, k: int) -> int:
    """Dynamic shared memory of one CTA of the assign launch at width m."""
    return int(_lib().apnc_assign_smem_bytes(m, k))


def ctas_per_sm(m: int, k: int) -> int:
    """CTAs of the assign launch at width m that one SM holds at once."""
    blocks = int(_lib().apnc_assign_ctas_per_sm(m, k))
    if blocks < 0:
        build.check(-blocks, "apnc_assign occupancy")
    return blocks


def _tile_rows(m: int) -> int:
    return TILE_ROWS if m <= MAX_M else WIDE_TILE_ROWS


def launch_geometry(n: int, m: int) -> lloyd_step.Geometry:
    """The CTAs of the assign launch over n rows of width m: the fused steps'
    geometry up to ``MAX_M``, the streamed kernel's 64-row tiles above."""
    return lloyd_step.launch_geometry(n, _tile_rows(m))


def _check_inputs(Y, C, discrepancy) -> None:
    if discrepancy not in ("l2", "l1"):
        raise ValueError(f"unknown discrepancy {discrepancy!r}")
    if Y.ndim != 2 or C.ndim != 2 or Y.shape[1] != C.shape[1]:
        raise ValueError(
            f"apnc_assign wants Y (n, m) and C (k, m), got {tuple(Y.shape)} "
            f"and {tuple(C.shape)}"
        )
    if C.shape[0] == 0:
        raise ValueError("apnc_assign needs at least one centroid")
    for name, t in (("Y", Y), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Y.device:
            raise ValueError(f"{name} is on {t.device}, Y on {Y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"apnc_assign runs on cuda or cpu, not {Y.device}")


def _launch(Y: torch.Tensor, C: torch.Tensor, discrepancy: str):
    n, m = Y.shape
    k = C.shape[0]
    with lloyd_step.step_launch(n, k, m, Y.device, _tile_rows(m), max_m=None) as (
            out, ptrs, num_ctas, tiles_per_cta, stream):
        if n == 0:
            return out
        err = _lib().apnc_assign_f32(
            Y.data_ptr(), C.data_ptr(), *ptrs, n, m, k, int(discrepancy == "l1"),
            num_ctas, tiles_per_cta, stream,
        )
    build.check(err, "apnc_assign launch")
    _count()
    if discrepancy == "l1":
        obs.counter("launch.apnc_assign.l1").inc()
    return out


def apnc_assign_step(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Y (n, m) f32, C (k, m) f32 -> Z (k, m) f32, g (k,) f32, labels (n,)
    int32, cost () f32 (the sum over rows of min e, sqrt'd for l2: the
    block's ``block_cost``), under the declared discrepancy ("l2" | "l1"),
    in one launch."""
    with build.launch_scope("apnc_assign", Y, discrepancy=discrepancy):
        _check_inputs(Y, C, discrepancy)
        if Y.device.type == "cpu":
            return apnc_assign_step_ref(Y, C, discrepancy)
        return _launch(Y, C, discrepancy)


def apnc_assign(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Y (n, m) f32, C (k, m) f32 -> Z (k, m) f32, g (k,) f32, labels (n,) int32,
    under the declared discrepancy ("l2" | "l1"): ``apnc_assign_step`` without
    its cost."""
    with build.launch_scope("apnc_assign", Y, discrepancy=discrepancy):
        _check_inputs(Y, C, discrepancy)
        if Y.device.type == "cpu":
            return apnc_assign_ref(Y, C, discrepancy)
        return _launch(Y, C, discrepancy)[:3]
