"""Causal flash attention over flat heads: a hand-written CUDA kernel.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_bhsd``, the
Pallas TPU kernel. The source is ``csrc/flash_attention.cu``; its header
holds the bound on an H100 and what the design does about it
(operation-bound: 4 * Dh * S(S+1)/2 operations per head, run on the tensor
cores as 3xTF32; one CTA owns 64 query rows and walks the live key tiles,
brought by cp.async, with the running max, sum and accumulator in
registers, so the (S, S) scores never reach device memory).

The TPU kernel takes (B*H, S, Dh) padded to its tiles; this one reads q, k,
v in the model's (B, S, H, Dh) layout through their strides and masks
ragged S and head dims itself, so the wrapper makes no transposed or padded
copy. k and v may carry fewer heads than q (grouped KV heads): query head h
reads KV head h // (H // Hkv) in place. The kernel's masks use the row and
column indices as positions.

``flash_attention_bhsd`` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors it computes the same function with the plain
PyTorch version. ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0

#: Largest head dim one launch takes (the kernel pads Dh to 64, 128 or 256).
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 6
                                   + [ctypes.POINTER(ctypes.c_longlong), _I, ctypes.c_float, _P])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [_I, _I]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention.cu and flash_attention.py disagree on MAX_HEAD_DIM")
    return lib


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one CTA of a launch at ``head_dim`` over
    inputs of ``dtype``."""
    return int(_lib().flash_attention_smem_bytes(head_dim, _DTYPES[dtype]))


def _check_inputs(q, k, v, window) -> None:
    if (q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or k.shape[:2] != q.shape[:2]
            or k.shape[3] != q.shape[3] or k.shape[2] < 1 or q.shape[2] % k.shape[2]):
        raise ValueError(
            f"flash_attention_bhsd wants q (B, S, H, Dh) and k, v (B, S, Hkv, Dh) with H a "
            f"multiple of Hkv, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} is outside the kernel's 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride 1)")
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0 (0: none), got {window!r}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """Causal (+ sliding window) softmax(q k^T Dh^-0.5) v.

    q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) with H a multiple of Hkv (query
    head h reads KV head h // (H // Hkv)); all float32 or all bfloat16,
    1 <= Dh <= 256, the head dim contiguous (any other strides).
    Position of row i is i; key j is seen by query i iff j <= i and, with
    ``window`` > 0, i - j < window. f32 arithmetic; returns (B, S, H, Dh) in
    q's dtype. Anything outside these limits raises, on either device.
    """
    global launches
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd runs on cuda or cpu, not {q.device}")
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, S, H, Hkv, Dh, strides, window, float(Dh ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention launch")
    launches += 1
    return out
