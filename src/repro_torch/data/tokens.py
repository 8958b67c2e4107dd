"""LM token pipeline: a deterministic synthetic corpus (numpy).

The corpus is a reproducible PRNG stream with a Zipf-ish skew, keyed by
(seed, step), so a batch is the same in both packages and a run resumes
exactly at a checkpointed step (``batch_iterator(..., start_step)``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def synthetic_batch(cfg: ArchConfig, step: int, batch: int, seq: int, seed: int = 17) -> dict:
    """Deterministic batch for a given step (numpy: cheap, no device compile)."""
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step))
    V = cfg.vocab_size
    # Zipf-ish skew over a capped support for signal; avoid index 0 (= pad)
    support = min(V, 32_768)
    raw = rng.zipf(1.3, size=(batch, seq + 8)) % support
    toks = (raw + 1).astype(np.int32)

    def seqmix(t):  # second-order structure: next token depends on previous
        t = t.copy()
        t[:, 1:] = (t[:, 1:] + (t[:, :-1] // 3)) % support + 1
        return t

    toks = seqmix(toks)[:, :seq]
    out: dict = {"loss_mask": np.ones((batch, seq), np.float32)}
    if cfg.frontend == "audio_codes":
        codes = np.stack([(toks + 7 * k) % V for k in range(cfg.num_codebooks)], axis=1)
        out["codes"] = codes.astype(np.int32)
    elif cfg.frontend == "vision_prefix":
        P = cfg.num_prefix_tokens
        out["tokens"] = (toks[:, : seq - P] % V).astype(np.int32)
        patch_rng = np.random.default_rng(np.uint64(seed) + np.uint64(step) * 31)
        out["patch_embeds"] = patch_rng.standard_normal(
            (batch, P, cfg.d_model), dtype=np.float32
        )
        out["loss_mask"][:, :P] = 0.0  # no loss on image positions
    else:
        out["tokens"] = (toks % V).astype(np.int32)
    return out


def batch_iterator(cfg: ArchConfig, batch: int, seq: int, start_step: int = 0,
                   device=None, seed: int = 17) -> Iterator[dict]:
    """Infinite iterator of ``synthetic_batch`` tensors on ``device`` (the card
    unless ``device="cpu"``), from ``start_step`` on. On a card each host
    array goes through a pinned buffer and a ``non_blocking`` copy."""
    dev = resolve_device(device)
    step = start_step
    while True:
        host = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, step, batch, seq,
                                                                    seed).items()}
        if dev.type == "cuda":
            yield {k: v.pin_memory().to(dev, non_blocking=True) for k, v in host.items()}
        else:
            yield {k: v.to(dev) for k, v in host.items()}
        step += 1
