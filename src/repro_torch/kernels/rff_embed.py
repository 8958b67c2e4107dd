"""Random Fourier features, Y = s [cos(X W), sin(X W)]: a hand-written CUDA kernel.

Replaces ``src/repro/kernels/rff_embed.py::rff_embed_block``, the Pallas TPU
kernel. The source is ``csrc/rff_embed.cu``; its header holds the bound on an
H100 and what the design does about it (operation-bound: 2*n*d*m_half f32
operations; the projection stays in registers through the trig, and cos and
sin are written straight into the two halves of Y).

``rff_embed_block`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it computes the same function with the plain
PyTorch version. ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rff_embed_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("rff_embed")
    lib.rff_embed_f32.argtypes = [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.rff_embed_f32.restype = ctypes.c_int
    return lib


def _check_inputs(X, W) -> None:
    if X.ndim != 2 or W.ndim != 2 or W.shape[0] != X.shape[1]:
        raise ValueError(
            f"rff_embed_block wants X (n, d) and W (d, m_half), got {tuple(X.shape)} "
            f"and {tuple(W.shape)}"
        )
    for name, t in (("X", X), ("W", W)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rff_embed_block(X: torch.Tensor, W: torch.Tensor, scale: float) -> torch.Tensor:
    """X (n, d) f32, W (d, m_half) f32 -> Y (n, 2 m_half) f32 in the [cos | sin]
    layout, each half scaled by ``scale``."""
    global launches
    _check_inputs(X, W)
    if X.device.type == "cpu":
        return rff_embed_ref(X, W, scale)
    if X.device.type != "cuda":
        raise ValueError(f"rff_embed_block runs on cuda or cpu, not {X.device}")
    n, d = X.shape
    mh = W.shape[1]
    Y = torch.empty((n, 2 * mh), dtype=torch.float32, device=X.device)
    if n == 0 or mh == 0:
        return Y
    err = _lib().rff_embed_f32(
        X.data_ptr(), W.data_ptr(), Y.data_ptr(), n, d, mh, 2 * mh, float(scale),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check(err, "rff_embed launch")
    launches += 1
    return Y
