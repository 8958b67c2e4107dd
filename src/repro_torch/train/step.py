"""Train and serve step builders.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``, the reference's signature, so
``train.loop.TrainLoop`` takes either package's step. It turns gradients on
for the model's parameters, computes them with ``torch.autograd.grad``
(microbatch accumulation into f32 buffers when ``accum_steps`` > 1), and
applies AdamW with the schedule's multiplier at ``opt_state.step``. The
parameters and moments are updated in place.

Each step also takes a `distributed.parallel.MeshLM` (the LM placed on a
device mesh by the sharding rules) with its moments placed the same way
(``parallel.shard_opt_state``): the train step then differentiates
``parallel.forward_train`` in the mesh's blocks, and the prefill and decode
steps run ``parallel.forward_prefill`` / ``forward_decode``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.models import model
from repro_torch.models.common import Policy
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState


def loss_fn(params, cfg: ArchConfig, policy: Policy, batch: dict):
    loss, metrics = model.forward_train(params, cfg, policy, batch)
    return loss, metrics


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """Every batch leaf (B, ...) cut into ``accum`` equal microbatches."""
    def split(x):
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} equal microbatches")
        return torch.chunk(x, accum, dim=0)

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def _grads(params: dict, loss: torch.Tensor) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def make_train_step(
    cfg: ArchConfig,
    policy: Policy,
    opt_cfg: AdamWConfig,
    schedule_fn: Callable[[int], float],
    accum_steps: int = 1,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    On a `distributed.parallel.MeshLM` the optimizer's leaves are its blocks
    (``MeshLM.leaves``), the moments the same blocks of ``opt_state.mu`` /
    ``nu``: ``adamw.global_norm`` adds up every block, so the clip is the
    one-device clip, and the decay predicate goes by the parameter's name
    and rank, the same for every block."""

    def train_step(params, opt_state: AdamWState, batch: dict):
        mesh = isinstance(params, parallel.MeshLM)
        named = params.leaves() if mesh else adamw.named(params)

        def forward(b):
            if mesh:
                return parallel.forward_train(params, policy, b)
            return loss_fn(params, cfg, policy, b)

        for p in named.values():
            p.requires_grad_(True)
        if accum_steps == 1:
            loss, metrics = forward(batch)
            grads = _grads(named, loss)
            loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            loss = None
            for mb in _split_microbatches(batch, accum_steps):
                l, _ = forward(mb)
                for n, g in _grads(named, l).items():
                    grads[n] += g.to(torch.float32)
                loss = l.detach() if loss is None else loss + l.detach()
            grads = {n: g / accum_steps for n, g in grads.items()}
            loss = loss / accum_steps  # mean of the microbatch means
            metrics = {}

        lr_scale = schedule_fn(int(opt_state.step))
        state = (AdamWState(opt_state.step, params.flat(opt_state.mu), params.flat(opt_state.nu))
                 if mesh else opt_state)
        _, state, opt_metrics = adamw.update(named, grads, state, opt_cfg, lr_scale)
        if mesh:  # the moments were updated in their blocks
            state = AdamWState(state.step, opt_state.mu, opt_state.nu)
        return params, state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, policy: Policy):
    def prefill_step(params, batch):
        if isinstance(params, parallel.MeshLM):
            return parallel.forward_prefill(params, policy, batch)
        return model.forward_prefill(params, cfg, policy, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: Policy):
    def serve_step(params, batch, cache, cache_len):
        """One new token for every sequence against a cache of fixed capacity."""
        if isinstance(params, parallel.MeshLM):
            return parallel.forward_decode(params, policy, batch, cache, cache_len)
        return model.forward_decode(params, cfg, policy, batch, cache, cache_len)

    return serve_step
