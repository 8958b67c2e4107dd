"""Fused APNC assignment, distances -> argmin -> (Z, g): a hand-written CUDA kernel.

Replaces ``src/repro/kernels/apnc_assign.py::apnc_assign_padded``, the Pallas
TPU kernel. The source is ``csrc/apnc_assign.cu``; its header holds the bound
on an H100 and what the design does about it (operation-bound: 2*n*k*m f32
operations; each Y tile is read once, up to m = 768, and streamed through
shared memory above; (Z, g) are reduced through per-CTA partials summed in a
fixed order, so they are bitwise deterministic).

``apnc_assign`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes the same function with the plain PyTorch version.
``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import apnc_assign_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0

#: Upper bound on the CTAs of one launch, and so on the (k, m) partials of Z
#: held in scratch. It depends on nothing but itself, so the order of the
#: final sum, and with it every bit of Z, is the same on every run.
MAX_CTAS = 264

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("apnc_assign")
    lib.apnc_assign_f32.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.apnc_assign_f32.restype = ctypes.c_int
    for fn in (lib.apnc_assign_max_m, lib.apnc_assign_tile_rows):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.apnc_assign_smem_bytes.argtypes = [_I, _I]
    lib.apnc_assign_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(m: int, k: int) -> int:
    """Dynamic shared memory of one CTA of the assign launch."""
    return int(_lib().apnc_assign_smem_bytes(m, k))


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


def apnc_assign(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Y (n, m) f32, C (k, m) f32 -> Z (k, m) f32, g (k,) f32, labels (n,) int32,
    under the declared discrepancy ("l2" | "l1")."""
    global launches
    _check_inputs(Y, C, discrepancy)
    if Y.device.type == "cpu":
        return apnc_assign_ref(Y, C, discrepancy)
    if Y.device.type != "cuda":
        raise ValueError(f"apnc_assign runs on cuda or cpu, not {Y.device}")
    n, m = Y.shape
    k = C.shape[0]
    dev = Y.device
    Z = torch.empty((k, m), dtype=torch.float32, device=dev)
    g = torch.empty((k,), dtype=torch.float32, device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return Z.zero_(), g.zero_(), labels
    lib = _lib()
    n_tiles = -(-n // lib.apnc_assign_tile_rows())
    tiles_per_cta = -(-n_tiles // min(n_tiles, MAX_CTAS))
    num_ctas = -(-n_tiles // tiles_per_cta)
    Zp = torch.empty((num_ctas, k, m), dtype=torch.float32, device=dev)
    gp = torch.empty((num_ctas, k), dtype=torch.float32, device=dev)
    err = lib.apnc_assign_f32(
        Y.data_ptr(), C.data_ptr(), Z.data_ptr(), g.data_ptr(), labels.data_ptr(),
        Zp.data_ptr(), gp.data_ptr(), n, m, k, int(discrepancy == "l1"),
        num_ctas, tiles_per_cta, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "apnc_assign launch")
    launches += 1
    return Z, g, labels
