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

The gradient. The launch goes through ``ctypes`` on raw pointers and records
no autograd history, so ``flash_attention_bhsd`` raises when it is called
under grad mode with a CUDA input that requires grad: a training call must
never get an answer without a gradient. Training reaches the kernel through
``FlashAttention``, an ``autograd.Function`` (``flash_attention`` applies
it): its forward launches the kernel and saves q, k, v; its backward,
``attention_backward``, recomputes the attention with ``torch`` ops in
chunks of ``BWD_CHUNK`` query rows and takes its gradient, so the live
memory is one (chunk x keys) tile a head and never the (S, S) scores. The
JAX package has no backward kernel either: it differentiates its ``jnp``
scan (``src/repro/models/attention.py::_flash_attention``), and so this
backward is plain PyTorch, not a hand-written kernel.

On ``meta`` tensors (the dry-run, ``launch.dryrun``) the launch is the op
``torch.ops.repro_torch.flash_attention``: its fake implementation gives
the output's shape and its flop formula counts the kernel's own work, the
causal lower triangle within the window, 4 Dh flops a live (query, key)
pair a head (``causal_pairs``); ``FlashAttention`` wraps it as it wraps the
launch, so a gradient on ``meta`` runs ``attention_backward``'s recompute
as the card does. The card's route is untouched by it.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0


def _count() -> None:
    """Count one launch; under a lock, since launches come from several
    threads (the serving tier's dispatcher, a swap's warm-up)."""
    global launches
    with build.LAUNCH_LOCK:
        launches += 1


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


def causal_pairs(S: int, window: int = 0) -> int:
    """The (query, key) pairs a causal attention over S rows reads: key j
    for query i when j <= i and, with a window, i - j < window."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """The kernel's function as an op, for counting: the plain version on the
    CPU; on ``meta`` its fake output."""
    return flash_attention_ref(q, k, v, window)


@_flash_op.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, window, *args, out_shape=None, **kwargs) -> int:
    B, S, H, Dh = q_shape
    return 4 * B * H * Dh * causal_pairs(S, window)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """Causal (+ sliding window) softmax(q k^T Dh^-0.5) v.

    q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) with H a multiple of Hkv (query
    head h reads KV head h // (H // Hkv)); all float32 or all bfloat16,
    1 <= Dh <= 256, the head dim contiguous (any other strides).
    Position of row i is i; key j is seen by query i iff j <= i and, with
    ``window`` > 0, i - j < window. f32 arithmetic; returns (B, S, H, Dh) in
    q's dtype. Anything outside these limits raises, on either device; on
    a card so does a call under grad mode with an input that requires grad
    (``flash_attention`` is the differentiable route).
    """
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bhsd runs on cuda, cpu or meta, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_bhsd's launch records no gradient, and an input requires "
            "grad: call flash_attention (the autograd Function), or ops.flash_attention")
    if q.device.type == "meta":
        return _flash_op(q, k, v, window)
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
    _count()
    return out


#: Query rows one step of ``attention_backward`` recomputes: its live scores
#: are (B, H, BWD_CHUNK, keys) f32.
BWD_CHUNK = 512


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                       window: int = 0, chunk: int | None = None):
    """(dq, dk, dv) of ``flash_attention_bhsd(q, k, v, window=window)`` against
    ``dout`` (B, S, H, Dh), in plain ``torch`` ops on the inputs' device.

    The inputs are copied once to a (B, heads, S, Dh) f32 layout, the
    queries pre-scaled by Dh^-0.5. Query rows then go ``chunk`` (default
    ``BWD_CHUNK``) at a time, the G query heads of a KV head stacked as
    G * chunk rows of one batched product against that head's keys. Each
    chunk recomputes its scores against the keys its rows can see (up to
    its last row; with a window, from its first row's window on), the
    softmax over whole rows, O = P V, and dP = dO V^T,
    dS = P (dP - rowsum(dO O)), dQ = dS K Dh^-0.5, dK += dS^T Q Dh^-0.5,
    dV += P^T dO, so dk and dv sum over the query heads that share a KV
    head. Each gradient comes back in its input's dtype and layout."""
    chunk = chunk or BWD_CHUNK
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5

    def heads(x):  # (B, S, h, Dh) -> (B, h, S, Dh) f32
        return x.to(torch.float32).transpose(1, 2).contiguous()

    qg = (heads(q) * scale).view(B, Hkv, G, S, Dh)
    dog = heads(dout).view(B, Hkv, G, S, Dh)
    kh, vh = heads(k), heads(v)
    dq = torch.empty_like(qg)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    pos = torch.arange(S, device=q.device)
    for i0 in range(0, S, chunk):
        i1 = min(S, i0 + chunk)
        j0 = max(0, i0 - window + 1) if window else 0
        c, T = i1 - i0, i1 - j0
        qc = qg[:, :, :, i0:i1].reshape(B, Hkv, G * c, Dh)
        doc = dog[:, :, :, i0:i1].reshape(B, Hkv, G * c, Dh)
        kc, vc = kh[:, :, j0:i1], vh[:, :, j0:i1]  # (B, Hkv, T, Dh)
        rel = pos[i0:i1, None] - pos[None, j0:i1]  # (c, T): query - key
        hidden = rel < 0
        if window:
            hidden = hidden | (rel >= window)
        s = torch.matmul(qc, kc.transpose(-1, -2))  # (B, Hkv, G * c, T)
        s.view(B, Hkv, G, c, T).masked_fill_(hidden, -torch.inf)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, j0:i1] += torch.matmul(p.transpose(-1, -2), doc)
        delta = torch.sum(doc * torch.matmul(p, vc), dim=-1, keepdim=True)  # rowsum(P dP)
        ds = torch.matmul(doc, vc.transpose(-1, -2)).sub_(delta).mul_(p)
        del p
        dq[:, :, :, i0:i1] = torch.matmul(ds, kc).view(B, Hkv, G, c, Dh) * scale
        dk[:, :, j0:i1] += torch.matmul(ds.transpose(-1, -2), qc)
        del ds

    def back(x, like):  # (B, h, S, Dh) -> like's layout and dtype
        return x.reshape(B, -1, S, Dh).transpose(1, 2).contiguous().to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


class FlashAttention(torch.autograd.Function):
    """``flash_attention_bhsd`` with a gradient: the forward launches the
    kernel (the plain version on the CPU) and saves q, k, v; the backward
    is ``attention_backward``'s recompute."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return flash_attention_bhsd(q, k, v, window=window)  # grad mode is off here

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, dout, ctx.window)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """``flash_attention_bhsd`` under autograd (``FlashAttention``): the
    training route to the kernel."""
    return FlashAttention.apply(q, k, v, window)
