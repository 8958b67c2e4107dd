"""LR schedules: linear warmup + cosine decay, and a constant.

Plain functions of the int step that return a float multiplier. The
arithmetic is float32, as the reference's ``jnp`` version computes it, so
both packages scale the learning rate alike.
"""
from __future__ import annotations

import numpy as np


def warmup_cosine(step: int, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> float:
    """Multiplier in [floor, 1]: step / warmup during the warmup, then a
    cosine from 1 down to ``floor`` at ``total``, and ``floor`` after."""
    s = np.float32(step)
    if s < warmup:
        return float(s / np.float32(max(warmup, 1)))
    prog = np.clip((s - np.float32(warmup)) / np.float32(max(total - warmup, 1)),
                   np.float32(0.0), np.float32(1.0))
    f = np.float32(floor)
    half = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * prog))
    return float(f + (np.float32(1.0) - f) * half)


def constant(step: int, *, value: float = 1.0) -> float:
    return float(np.float32(value))
