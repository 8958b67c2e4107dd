"""Serving step builders: one prefill step and one decode step over the LM.

The reference's ``make_train_step`` (gradient accumulation, AdamW) waits for
the training slice (ROADMAP.md Queue 1 item 15).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model
from repro_torch.models.common import Policy


def make_prefill_step(cfg: ArchConfig, policy: Policy):
    def prefill_step(params, batch):
        return model.forward_prefill(params, cfg, policy, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: Policy):
    def serve_step(params, batch, cache, cache_len):
        """One new token for every sequence against a cache of fixed capacity."""
        return model.forward_decode(params, cfg, policy, batch, cache, cache_len)

    return serve_step
