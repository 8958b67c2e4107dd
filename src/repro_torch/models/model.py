"""The LM model: embeddings -> layer groups -> head, for serving.

Entry points:
    init(generator, cfg, policy, device=None)          -> LM (an nn.Module)
    forward_prefill(params, cfg, policy, batch)        -> (last_logits (B, V), cache)
    forward_decode(params, cfg, policy, batch, cache, cache_len)
                                                       -> (logits (B, V), cache)
    init_cache(cfg, batch, max_len, dtype, device)     -> cache

``params`` is the ``LM`` module; its parameter names follow the reference's
params tree (``embed``, ``head``, ``final_norm``,
``groups.<g>.layer<i>.{norm1,norm2,mixer.*,ffn.*}``), with the groups an
``nn.ModuleList`` instead of a stacked leading axis. A cache is a list with
one dict per group, ``{"layer<i>": {"k", "v"[, "k_scale", "v_scale"]}}``,
each tensor (B, T, KV, Dh). The training half of the reference
(``forward_train`` and its chunked cross-entropy) waits for a later slice
(ROADMAP.md Queue 1 item 15), as do the audio and vision frontends.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import Policy, normal_init, rms_norm, sinusoidal_positions

_FRONTENDS = ("the {} frontend is not ported yet (ROADMAP.md Queue 1 item 15: the "
              "LM substrate's frontends)")


class LM(nn.Module):
    """``embed`` (V, d), ``head`` (d, V) unless tied, ``final_norm`` (d,) and
    ``groups``, one ``transformer.Group`` per repetition of the layer pattern."""

    def __init__(self, cfg: ArchConfig, policy: Policy, groups: list, device=None):
        super().__init__()
        if cfg.frontend == "audio_codes":  # K codebook embeddings and heads
            raise NotImplementedError(_FRONTENDS.format(cfg.frontend))
        V, d = cfg.vocab_size, cfg.d_model
        kw = dict(dtype=policy.param_dtype, device=device)
        self.embed = nn.Parameter(torch.empty((V, d), **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty((d, V), **kw), requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones((d,), **kw), requires_grad=False)
        self.groups = nn.ModuleList(groups)


def build(cfg: ArchConfig, policy: Policy, device=None) -> LM:
    """The model with its parameters allocated but not drawn (``init`` draws;
    ``convert.lm_params_from_numpy`` loads)."""
    dev = resolve_device(device)
    groups = [transformer.build_group(cfg, policy, dev) for _ in range(cfg.num_groups)]
    return LM(cfg, policy, groups, dev)


def init(generator: torch.Generator, cfg: ArchConfig, policy: Policy, device=None) -> LM:
    """Random-init model on ``device`` (the card unless ``device="cpu"``). Every
    draw comes from ``generator``, on its own device; the draws differ from
    ``jax.random``'s by construction."""
    dev = resolve_device(device)
    V, d, dt = cfg.vocab_size, cfg.d_model, policy.param_dtype
    embed = normal_init(generator, (V, d), dt)
    head = None if cfg.tie_embeddings else normal_init(generator, (d, V), dt)
    groups = [transformer.init_group(generator, cfg, policy, dev)
              for _ in range(cfg.num_groups)]
    model = LM(cfg, policy, groups, dev)
    model.embed.copy_(embed)
    if head is not None:
        model.head.copy_(head)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> list[dict]:
    dev = resolve_device(device)
    return [transformer.init_group_cache(cfg, batch, max_len, dtype, dev)
            for _ in range(cfg.num_groups)]


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def embed_inputs(params: LM, cfg: ArchConfig, policy: Policy, batch: dict,
                 position_offset: int = 0) -> torch.Tensor:
    """Returns x (B, S, d) in compute dtype, from ``batch["tokens"]`` (B, S)."""
    if cfg.frontend != "none":
        raise NotImplementedError(_FRONTENDS.format(cfg.frontend))
    x = torch.nn.functional.embedding(batch["tokens"], policy.cast(params.embed))
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device) + position_offset
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x


def _head_logits(params: LM, cfg: ArchConfig, policy: Policy, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V)."""
    w = policy.cast(params.embed.T if cfg.tie_embeddings else params.head)
    return x @ w


def forward_prefill(params: LM, cfg: ArchConfig, policy: Policy,
                    batch: dict) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence forward that also builds the decode cache (bf16 k, v of
    length S). Returns (logits of the last position (B, V), cache)."""
    x = embed_inputs(params, cfg, policy, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = []
    for group in params.groups:
        x, cache_g = transformer.apply_group_prefill(group, cfg, policy, x, positions)
        cache.append(cache_g)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _head_logits(params, cfg, policy, x[:, -1:])[:, 0], cache


def forward_decode(params: LM, cfg: ArchConfig, policy: Policy, batch: dict,
                   cache: list[dict], cache_len: int) -> tuple[torch.Tensor, list[dict]]:
    """One token for every sequence in the batch, written into the cache at
    ``cache_len`` in place. Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, policy, batch, position_offset=cache_len)  # (B, 1, d)
    for group, cache_g in zip(params.groups, cache):
        x, _ = transformer.apply_group_decode(group, cfg, policy, x, cache_g, cache_len)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _head_logits(params, cfg, policy, x)[:, 0], cache
