"""The LM model: embeddings (and the frontends) -> layer groups -> head(s).

Entry points:
    init(generator, cfg, policy, device=None)          -> LM (an nn.Module)
    forward_train(params, cfg, policy, batch)          -> (loss, {"ce", "aux"})
    forward_prefill(params, cfg, policy, batch)        -> (last_logits, cache)
    forward_decode(params, cfg, policy, batch, cache, cache_len)
                                                       -> (logits, cache)
    init_cache(cfg, batch, max_len, dtype, device)     -> cache

A batch holds ``tokens`` (B, S); with the ``audio_codes`` frontend
(musicgen) ``codes`` (B, K, S) instead, embedded per codebook and summed,
with one head per codebook, the logits (B, K, V); with ``vision_prefix``
(llava) also ``patch_embeds`` (B, P, d) at prefill and training,
concatenated ahead of the token embeddings (decode steps are text-only).

``params`` is the ``LM`` module; its parameter names follow the reference's
params tree (``embed``, ``head``, ``final_norm``,
``groups.<g>.layer<i>.{norm1,norm2,mixer.*,ffn.*}``), with the groups an
``nn.ModuleList`` instead of a stacked leading axis. A cache is a list with
one dict per group, ``{"layer<i>": state}``: an attention layer's ``{"k",
"v"[, "k_scale", "v_scale"]}``, each (B, T, KV, Dh); a Mamba layer's ``{"h",
"conv"}``; an RWKV6 layer's ``{"S", "x_tmix", "x_cmix"}``.

Parameters are built with ``requires_grad=False``, for serving; the
training entry points (``train.step``) turn gradients on. Training memory:
with ``cfg.remat == "full"`` each layer group runs under
``torch.utils.checkpoint`` (the counterpart of the reference's
``jax.checkpoint`` on its scan body), so only the groups' inputs are kept;
the cross-entropy is chunked over the sequence, ``LOSS_CHUNK`` positions a
chunk, each under ``checkpoint``, so the (B, S, V) logits never
materialize.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import Policy, normal_init, rms_norm, sinusoidal_positions

LOSS_CHUNK = 512


def _embed_shapes(cfg: ArchConfig) -> tuple[tuple, tuple]:
    """(embed, head) shapes: (V, d), (d, V); (K, V, d), (K, d, V) for audio codes."""
    V, d, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks
    if cfg.frontend == "audio_codes":
        return (K, V, d), (K, d, V)
    return (V, d), (d, V)


class LM(nn.Module):
    """``embed`` (V, d), ``head`` (d, V) unless tied, ``final_norm`` (d,) and
    ``groups``, one ``transformer.Group`` per repetition of the layer
    pattern; with audio codes ``embed`` (K, V, d) and ``head`` (K, d, V)."""

    def __init__(self, cfg: ArchConfig, policy: Policy, groups: list, device=None):
        super().__init__()
        embed, head = _embed_shapes(cfg)
        kw = dict(dtype=policy.param_dtype, device=device)
        self.embed = nn.Parameter(torch.empty(embed, **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(head, **kw), requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones((cfg.d_model,), **kw), requires_grad=False)
        self.groups = nn.ModuleList(groups)
        self.cfg = cfg


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
    embed_shape, head_shape = _embed_shapes(cfg)
    embed = normal_init(generator, embed_shape, policy.param_dtype)
    head = None if cfg.tie_embeddings else normal_init(generator, head_shape, policy.param_dtype)
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


def token_embeds(emb: torch.Tensor, cfg: ArchConfig, batch: dict, v0: int = 0) -> torch.Tensor:
    """The embeddings (B, S, d) of ``batch["tokens"]`` from ``emb`` (V', d)
    or, for audio codes, the sum over the K codebooks of ``batch["codes"]``
    (B, K, S) from ``emb`` (K, V', d). ``emb`` may hold only the vocab rows
    [v0, v0 + V') (a vocab shard's, ``distributed.parallel``): an id
    outside them embeds to zero."""

    def lookup(ids, table):
        V = table.shape[0]
        if V == cfg.vocab_size:
            return F.embedding(ids, table)
        inr = (ids >= v0) & (ids < v0 + V)
        return F.embedding((ids - v0).clamp(0, V - 1), table) * inr[..., None].to(table.dtype)

    if cfg.frontend == "audio_codes":
        codes = batch["codes"]
        x = lookup(codes[:, 0], emb[0])
        for k in range(1, cfg.num_codebooks):
            x = x + lookup(codes[:, k], emb[k])
        return x
    return lookup(batch["tokens"], emb)


def frontend(cfg: ArchConfig, policy: Policy, batch: dict, x: torch.Tensor) -> torch.Tensor:
    """The token embeddings x with, for vision, ``batch["patch_embeds"]``
    ahead of them where present, and sinusoidal positions from 0."""
    if cfg.frontend == "vision_prefix" and "patch_embeds" in batch:
        x = torch.cat([policy.cast(batch["patch_embeds"]), x], dim=1)
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x


def embed_inputs(params: LM, cfg: ArchConfig, policy: Policy, batch: dict) -> torch.Tensor:
    """Returns x (B, S, d) in compute dtype (the reference's stub frontends):
    audio codes, the sum of the K codebooks' embeddings of ``batch["codes"]``
    (B, K, S); vision, ``batch["patch_embeds"]`` (B, P, d), where present,
    ahead of the embeddings of ``batch["tokens"]``; else ``batch["tokens"]``
    (B, S). Sinusoidal positions from 0."""
    return frontend(cfg, policy, batch, token_embeds(policy.cast(params.embed), cfg, batch))


def at_position(cfg: ArchConfig, x: torch.Tensor, cache_len: int) -> torch.Tensor:
    """A decode step's embeddings moved to position ``cache_len``, the
    reference's way: ``embed_inputs`` added position 0's sinusoid."""
    if cfg.pos_emb != "sinusoidal":
        return x
    table = sinusoidal_positions(torch.tensor([0, cache_len], device=x.device),
                                 cfg.d_model).to(x.dtype)
    return x - table[:1] + table[1:]


def _head_logits(params: LM, cfg: ArchConfig, policy: Policy, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V); audio codes (B, K, S, V)."""
    if cfg.frontend == "audio_codes":
        return torch.einsum("bsd,kdv->bksv", x, policy.cast(params.head))
    w = policy.cast(params.embed.T if cfg.tie_embeddings else params.head)
    return x @ w


def _labels(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Token ids aligned with the model sequence: the codes (B, K, S) for
    audio; for vision zeros at the P prefix positions, then the tokens."""
    if cfg.frontend == "audio_codes":
        return batch["codes"]
    if cfg.frontend == "vision_prefix":
        B, P = batch["patch_embeds"].shape[:2]
        tokens = batch["tokens"]
        pad = torch.zeros((B, P), dtype=tokens.dtype, device=tokens.device)
        return torch.cat([pad, tokens], dim=1)
    return batch["tokens"]


def ce_stats(params, cfg: ArchConfig, policy: Policy, x_chunk: torch.Tensor,
             labels_chunk: torch.Tensor, v0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) of one sequence chunk's logits; they live
    only inside this function. ``params``' head may hold only the vocab rows
    [v0, v0 + V') (a vocab shard's): then the logsumexp is over those, and
    a label outside them scores 0."""
    logits = _head_logits(params, cfg, policy, x_chunk).to(torch.float32)
    V = logits.shape[-1]
    if V == cfg.vocab_size:
        gold = torch.gather(logits, -1, labels_chunk[..., None].long())[..., 0]
    else:
        inr = (labels_chunk >= v0) & (labels_chunk < v0 + V)
        idx = (labels_chunk - v0).clamp(0, V - 1)
        gold = torch.gather(logits, -1, idx[..., None].long())[..., 0] * inr.to(torch.float32)
    return torch.logsumexp(logits, dim=-1), gold


def ce_sums(cfg: ArchConfig, labels: torch.Tensor, mask: torch.Tensor,
            stats) -> tuple[torch.Tensor, torch.Tensor]:
    """The sums of the masked next-token CE and of the mask, LOSS_CHUNK
    positions at a time (the last chunk may be shorter, the ragged tail).
    Position i predicts label i + 1; ``stats(c0, c1, y)`` gives the
    (logsumexp, gold logit) of the positions [c0, c1) for their labels y."""
    y, m = labels[..., 1:], mask[:, 1:]
    Sm = m.shape[1]
    chunk = min(LOSS_CHUNK, Sm)
    tot = torch.zeros((), dtype=torch.float32, device=m.device)
    cnt = torch.zeros((), dtype=torch.float32, device=m.device)
    for c0 in range(0, Sm, chunk):
        c1 = min(Sm, c0 + chunk)
        logz, gold = stats(c0, c1, y[..., c0:c1])
        mc = m[:, c0:c1]
        # audio codes: logz, gold (B, K, Sc) against the mask (B, Sc)
        nll = (logz - gold) * (mc[:, None, :] if cfg.frontend == "audio_codes" else mc)
        tot, cnt = tot + torch.sum(nll), cnt + torch.sum(mc)
    return tot, cnt


def _chunked_ce(params: LM, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE, each chunk's logits under ``checkpoint`` (recomputed in
    the backward), so the (B, S, V) logits never materialize."""

    def stats(c0, c1, y):
        return checkpoint(ce_stats, params, cfg, policy, x[:, c0:c1], y, use_reentrant=False)

    tot, cnt = ce_sums(cfg, labels, mask, stats)
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params: LM, cfg: ArchConfig, policy: Policy,
                  batch: dict) -> tuple[torch.Tensor, dict]:
    """Returns (loss, {"ce", "aux"}): the next-token CE over the batch's
    labels (``_labels``: the tokens, the codes of every codebook, or zeros
    at a vision prefix) weighted by ``batch["loss_mask"]`` (B, S) (all ones
    if absent; the prefix's positions zero in ``data.tokens``), plus the MoE
    layers' aux loss. Differentiable in the parameters that require grad."""
    x = embed_inputs(params, cfg, policy, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group in params.groups:
        if cfg.remat == "full":
            x, aux_g = checkpoint(transformer.apply_group_full, group, cfg, policy, x,
                                  positions, use_reentrant=False)
        else:
            x, aux_g = transformer.apply_group_full(group, cfg, policy, x, positions)
        aux = aux + aux_g
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((B, S), dtype=x.dtype, device=x.device)
    ce = _chunked_ce(params, cfg, policy, x, _labels(cfg, batch), mask.to(torch.float32))
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def forward_prefill(params: LM, cfg: ArchConfig, policy: Policy,
                    batch: dict) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence forward that also builds the decode cache (bf16 k, v of
    length S; the SSM layers' states). Returns (logits of the last position
    (B, V), or (B, K, V) for audio codes, cache)."""
    x = embed_inputs(params, cfg, policy, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = []
    for group in params.groups:
        x, cache_g = transformer.apply_group_prefill(group, cfg, policy, x, positions)
        cache.append(cache_g)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _last(cfg, _head_logits(params, cfg, policy, x[:, -1:])), cache


def _last(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """The one position of (B, 1, V) or, for audio codes, (B, K, 1, V) logits."""
    return logits[:, :, 0] if cfg.frontend == "audio_codes" else logits[:, 0]


def forward_decode(params: LM, cfg: ArchConfig, policy: Policy, batch: dict,
                   cache: list[dict], cache_len: int) -> tuple[torch.Tensor, list[dict]]:
    """One token for every sequence in the batch (``tokens`` (B, 1), or
    ``codes`` (B, K, 1)), written into the cache at ``cache_len``: the
    attention caches in place, the SSM states replaced in the cache's dicts.
    Returns (logits (B, V) or (B, K, V), cache)."""
    x = at_position(cfg, embed_inputs(params, cfg, policy, batch), cache_len)  # (B, 1, d)
    for group, cache_g in zip(params.groups, cache):
        x, _ = transformer.apply_group_decode(group, cfg, policy, x, cache_g, cache_len)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _last(cfg, _head_logits(params, cfg, policy, x)), cache
