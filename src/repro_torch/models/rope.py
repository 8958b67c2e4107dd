"""Rotary position embeddings (half-split convention, as llama/qwen)."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> (cos, sin) of shape (..., head_dim // 2) f32.

    The frequencies and the angles are computed in f32, as the reference
    does: computed in f64 and cast, they would round differently, and over
    many layers the ulps compound."""
    half = head_dim // 2
    base = torch.tensor(theta, dtype=torch.float32, device=positions.device)
    freq = torch.pow(base, -torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, Dh/2) (or broadcastable). Half-split:
    rotate pairs (x[..., :Dh/2], x[..., Dh/2:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # (B, S, 1, Dh/2)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
