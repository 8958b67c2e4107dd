"""Fused APNC embedding, Y = kappa(X, L) @ R^T: a hand-written CUDA kernel.

Replaces ``src/repro/kernels/apnc_embed.py::apnc_embed_block``, the Pallas TPU
kernel. The source is ``csrc/apnc_embed.cu`` over the mainloop of
``csrc/apnc_mainloop.cuh``, which ``fused_apnc_step`` shares; its header
holds the bound on an H100 and what the design does about it
(operation-bound: 2*n*l*(d + m) f32 operations; one CTA embeds a 32- or
64-row tile over 256-landmark super-tiles with every operand brought by
cp.async, so the (n, l) gram never reaches device memory).

``apnc_embed_block`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it computes the same function with the plain PyTorch
version. ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.kernels import build
from repro_torch.kernels.ref import apnc_embed_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0

_KINDS = {"rbf": 0, "poly": 1, "tanh": 2, "linear": 3}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load("apnc_embed")
    for fn in (lib.apnc_embed_f32, lib.apnc_embed_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.apnc_embed_max_m.argtypes = []
    lib.apnc_embed_max_m.restype = ctypes.c_int
    lib.apnc_embed_smem_bytes.argtypes = [_I, _I]
    lib.apnc_embed_smem_bytes.restype = ctypes.c_longlong
    lib.apnc_embed_tile_rows.argtypes = [_I, _I]
    lib.apnc_embed_tile_rows.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one CTA for a launch of n rows and m columns."""
    return int(_lib().apnc_embed_smem_bytes(n, min(m, _lib().apnc_embed_max_m())))


def tile_rows(n: int, m: int) -> int:
    """Rows a CTA embeds in a launch of n rows and m columns: 64 for a launch
    of many waves, 32 otherwise (the kernel picks; the bits do not depend on
    it)."""
    return int(_lib().apnc_embed_tile_rows(n, min(m, _lib().apnc_embed_max_m())))


def _check_inputs(X, landmarks, R, out) -> None:
    if X.ndim != 2 or landmarks.ndim != 2 or R.ndim != 2:
        raise ValueError("apnc_embed_block wants X (n, d), landmarks (l, d), R (m, l)")
    n, d = X.shape
    l, m = landmarks.shape[0], R.shape[0]
    if landmarks.shape[1] != d or R.shape[1] != l:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, landmarks "
            f"{tuple(landmarks.shape)}, R {tuple(R.shape)}"
        )
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    for name, t in (("landmarks", landmarks), ("R", R)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("X", X), ("landmarks", landmarks), ("R", R)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out is not None:
        if out.dtype != torch.float32 or out.device != X.device:
            raise ValueError("out must be float32 on X's device")
        if out.shape[0] != n or out.shape[1] != m or out.stride(1) != 1:
            raise ValueError(f"out must be ({n}, {m}) with unit column stride")


def apnc_embed_block(
    X: torch.Tensor, landmarks: torch.Tensor, R: torch.Tensor, kernel: Kernel,
    *, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One APNC block: X (n, d) f32/bf16, landmarks (l, d) f32, R (m, l) f32
    -> Y (n, m) f32. ``out`` may be a column slice of a wider (n, M) tensor
    (row pitch M, unit column stride): the kernel writes into it in place."""
    global launches
    _check_inputs(X, landmarks, R, out)
    if X.device.type == "cpu":
        Y = apnc_embed_ref(X, landmarks[None], R[None], kernel)
        if out is None:
            return Y
        out.copy_(Y)
        return out
    if X.device.type != "cuda":
        raise ValueError(f"apnc_embed_block runs on cuda or cpu, not {X.device}")
    if kernel.name not in _KINDS:
        raise ValueError(f"unknown kernel {kernel.name!r}")
    n, d = X.shape
    l, m = landmarks.shape[0], R.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    if n == 0 or m == 0:
        return out
    lib = _lib()
    fn = lib.apnc_embed_f32 if X.dtype == torch.float32 else lib.apnc_embed_bf16
    stream = torch.cuda.current_stream(X.device).cuda_stream
    max_m = lib.apnc_embed_max_m()
    # Blocks wider than one launch's shared-memory budget go in column
    # groups; each group recomputes kappa(X, L) for its rows.
    for c0 in range(0, m, max_m):
        c1 = min(m, c0 + max_m)
        Rg, Yg = R[c0:c1], out[:, c0:c1]
        err = fn(
            X.data_ptr(), landmarks.data_ptr(), Rg.data_ptr(), Yg.data_ptr(),
            n, d, l, c1 - c0, out.stride(0), _KINDS[kernel.name],
            float(kernel.gamma), float(kernel.coef0), float(kernel.scale),
            int(kernel.degree), stream,
        )
        build.check(err, "apnc_embed launch")
        launches += 1
    return out
