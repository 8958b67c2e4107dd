"""Plain PyTorch versions of the hand-written kernels.

They compute the same functions as ``apnc_embed``, ``apnc_assign`` (and
``apnc_assign_step``), ``rff_embed_block``, ``fused_apnc_step``, ``fused_rff_step`` and
``fused_dequant_step`` (and its decode) and ``flash_attention_bhsd``, with the same
contracts as the JAX package's oracles. The wrappers use them for CPU
tensors; on the card they are only the yardstick the kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.apnc import (Discrepancy, embed_block, pairwise_discrepancy,
                                   sufficient_stats)
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.lloyd import block_cost


def apnc_embed_ref(
    X: torch.Tensor, landmarks: torch.Tensor, R: torch.Tensor, kernel: Kernel
) -> torch.Tensor:
    """Y = kappa(X, L) @ R^T per block, concatenated, computed in f32.

    X: (n, d); landmarks: (q, l_b, d); R: (q, m_b, l_b)  ->  (n, q * m_b) f32.
    """
    Xf = X.to(torch.float32)
    parts = [
        embed_block(Xf, landmarks[b].to(torch.float32), R[b].to(torch.float32), kernel)
        for b in range(landmarks.shape[0])
    ]
    return torch.cat(parts, dim=-1)


def apnc_assign_ref(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distances -> argmin -> sufficient stats.

    Y: (n, m), C: (k, m)  ->  Z (k, m) f32, g (k,) f32, labels (n,) int32.
    """
    Yf = Y.to(torch.float32)
    Cf = C.to(torch.float32)
    labels = torch.argmin(pairwise_discrepancy(Yf, Cf, discrepancy), dim=-1)
    Z, g = sufficient_stats(Yf, labels, C.shape[0])
    return Z, g, labels.to(torch.int32)


def rff_embed_ref(X: torch.Tensor, W: torch.Tensor, scale: float) -> torch.Tensor:
    """Y = scale [cos(X W), sin(X W)]: X (n, d), W (d, m_half) -> (n, 2 m_half) f32."""
    proj = X.to(torch.float32) @ W.to(torch.float32)
    return scale * torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def apnc_assign_step_ref(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``apnc_assign_ref`` and the block's cost: Y (n, m), C (k, m) -> Z (k, m)
    f32, g (k,) f32, labels (n,) int32, cost () f32 in ``block_cost``'s units
    (the sum over rows of min e, sqrt'd for l2)."""
    Z, g, labels = apnc_assign_ref(Y, C, discrepancy)
    return Z, g, labels, block_cost(Y, C.to(torch.float32), discrepancy)


def fused_apnc_step_ref(
    X: torch.Tensor, landmarks: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
    kernel: Kernel, discrepancy: Discrepancy,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd block step of a q = 1 APNC member, un-fused: embed, assign,
    stats and cost. X (n, d), landmarks (l, d), R (m, l), C (k, m) ->
    Z (k, m) f32, g (k,) f32, labels (n,) int32, cost () f32."""
    return apnc_assign_step_ref(apnc_embed_ref(X, landmarks[None], R[None], kernel), C, discrepancy)


def fused_rff_step_ref(
    X: torch.Tensor, W: torch.Tensor, C: torch.Tensor, scale: float, discrepancy: Discrepancy,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd block step of the rff member, un-fused. X (n, d), W (d, m_half),
    C (k, 2 m_half) in the [cos | sin] layout -> as ``fused_apnc_step_ref``."""
    return apnc_assign_step_ref(rff_embed_ref(X, W, scale), C, discrepancy)


def dequant_ref(Yq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode a cache block: Yq (n, m) int8 or bf16 times its scale, (1, m)
    or a scalar, one rounded f32 multiply per element -> (n, m) f32."""
    return Yq.to(torch.float32) * scale.to(torch.float32)


def fused_dequant_step_ref(
    Yq: torch.Tensor, scale: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd step over a quantized cache block, un-fused: decode, assign,
    stats and cost. Yq (n, m) int8 or bf16, scale (1, m) f32 (int8) or the
    scalar 1.0 (bf16), C (k, m) -> Z (k, m) f32, g (k,) f32, labels (n,)
    int32, cost () f32 in ``block_cost``'s units (sqrt'd for l2)."""
    return apnc_assign_step_ref(dequant_ref(Yq, scale), C, discrepancy)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Direct masked softmax attention over flat heads, in f32: q (B, S, H,
    Dh), k, v (B, S, Hkv, Dh) with H a multiple of Hkv (query head h reads KV
    head h // (H // Hkv)) -> (B, S, H, Dh) in q's dtype. Causal on the row
    indices, and with ``window`` > 0 only keys with i - j < window."""
    Dh = q.shape[-1]
    reps = q.shape[2] // k.shape[2]
    if reps > 1:
        k, v = (t.repeat_interleave(reps, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bthd->bhqt", q.to(torch.float32),
                     k.to(torch.float32)) * (Dh ** -0.5)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    s = torch.where(mask[None, None], s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,bthd->bqhd", w, v.to(torch.float32))
    return out.to(q.dtype)
