"""Fused Lloyd steps, embed + assign + (Z, g, cost) in one launch: hand-written CUDA kernels.

Replaces ``src/repro/kernels/lloyd_step.py::fused_apnc_step`` and
``::fused_rff_step``, the Pallas TPU kernels. The source is
``csrc/lloyd_step.cu`` with its epilogue in ``csrc/lloyd_epilogue.cuh``; its
header holds the bound on an H100 and what the design does about it
(operation-bound; one CTA embeds 64 rows into a shared-memory tile that the
assign epilogue reads in place, so Y never reaches device memory; (Z, g, cost)
go through per-CTA partials summed in a fixed order, so they are bitwise
deterministic).

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes the same function with the plain PyTorch version.
``launches`` counts kernel launches per kernel, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_apnc_step_ref, fused_rff_step_ref

#: Kernel launches so far, per kernel (CUDA tensors only).
launches = {"fused_apnc_step": 0, "fused_rff_step": 0}

#: Largest embedding width (rff: 2 * m_half) one launch takes: the (64 x m)
#: Y tile lives in shared memory. ``csrc/lloyd_step.cu`` holds the same bound.
MAX_M = 512

#: Upper bound on the CTAs of one launch, and so on the (k, m) partials held
#: in scratch. It depends on nothing but itself, so the order of the final
#: sums, and with them every bit of (Z, g, cost), is the same on every run.
MAX_CTAS = 264

_KINDS = {"rbf": 0, "poly": 1, "tanh": 2, "linear": 3}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("lloyd_step")
    lib.fused_apnc_step_f32.argtypes = [_P] * 11 + [_I] * 9 + [_F, _F, _F, _I, _P]
    lib.fused_rff_step_f32.argtypes = [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P]
    for fn in (lib.fused_apnc_step_f32, lib.fused_rff_step_f32, lib.lloyd_step_max_m,
               lib.lloyd_step_tile_rows):
        fn.restype = ctypes.c_int
    for fn in (lib.lloyd_step_max_m, lib.lloyd_step_tile_rows):
        fn.argtypes = []
    for fn in (lib.fused_apnc_smem_bytes, lib.fused_rff_smem_bytes):
        fn.argtypes = [_I]
        fn.restype = ctypes.c_longlong
    if lib.lloyd_step_max_m() != MAX_M:
        raise RuntimeError("lloyd_step.cu and lloyd_step.py disagree on MAX_M")
    return lib


def smem_bytes(member: str, m: int) -> int:
    """Dynamic shared memory of one CTA of the fused launch for ``member``
    ("apnc" | "rff") at embedding width m."""
    lib = _lib()
    fn = lib.fused_apnc_smem_bytes if member == "apnc" else lib.fused_rff_smem_bytes
    return int(fn(m))


def _check(named: dict, discrepancy: str) -> None:
    if discrepancy not in ("l2", "l1"):
        raise ValueError(f"unknown discrepancy {discrepancy!r}")
    dev = named["X"].device
    for name, t in named.items():
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if named["C"].shape[0] == 0:
        raise ValueError("a Lloyd step needs at least one centroid")


def _outputs(n: int, k: int, m: int, dev: torch.device):
    """The outputs (Z, g, labels, cost) of one launch, the pointers the C entry
    takes for them and for the per-CTA scratch, and the launch's CTA count and
    tiles per CTA."""
    if m > MAX_M:
        raise NotImplementedError(
            f"the fused Lloyd step holds a (64 x m) Y tile in shared memory and "
            f"takes m <= {MAX_M}, got m={m}; ops.fused_member routes wider params "
            f"to the un-fused kernels"
        )
    out = (torch.empty((k, m), dtype=torch.float32, device=dev),
           torch.empty((k,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((), dtype=torch.float32, device=dev))
    if n == 0:  # no launch: the sums over no rows
        for t in (out[0], out[1], out[3]):
            t.zero_()
    n_tiles = -(-n // _lib().lloyd_step_tile_rows())
    tiles_per_cta = -(-n_tiles // max(1, min(n_tiles, MAX_CTAS)))
    num_ctas = -(-n_tiles // max(1, tiles_per_cta))
    Zp = torch.empty((num_ctas, k, m), dtype=torch.float32, device=dev)
    gp = torch.empty((num_ctas, k), dtype=torch.float32, device=dev)
    costp = torch.empty((num_ctas,), dtype=torch.float32, device=dev)
    Z, g, labels, cost = out
    ptrs = [Z.data_ptr(), g.data_ptr(), cost.data_ptr(), labels.data_ptr(),
            Zp.data_ptr(), gp.data_ptr(), costp.data_ptr()]
    return out, ptrs, num_ctas, tiles_per_cta


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
    out, ptrs, num_ctas, tiles_per_cta = _outputs(n, k, m, X.device)
    if n == 0:
        return out
    err = _lib().fused_apnc_step_f32(
        X.data_ptr(), landmarks.data_ptr(), R.data_ptr(), C.data_ptr(), *ptrs,
        n, d, l, m, k, int(discrepancy == "l1"), num_ctas, tiles_per_cta,
        _KINDS[kernel.name], float(kernel.gamma), float(kernel.coef0),
        float(kernel.scale), int(kernel.degree),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check(err, "fused_apnc_step launch")
    launches["fused_apnc_step"] += 1
    return out


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
    out, ptrs, num_ctas, tiles_per_cta = _outputs(n, k, 2 * mh, X.device)
    if n == 0:
        return out
    err = _lib().fused_rff_step_f32(
        X.data_ptr(), W.data_ptr(), C.data_ptr(), *ptrs,
        n, d, mh, k, int(discrepancy == "l1"), float(scale), num_ctas, tiles_per_cta,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check(err, "fused_rff_step launch")
    launches["fused_rff_step"] += 1
    return out
