"""Layer-group assembly. A "group" is one repetition of the arch's layer
pattern (length p): dense and MoE archs p = 1 ([attn + ffn]); rwkv6 p = 1
([rwkv6 time-mix + channel-mix]); jamba p = 8 (Mamba layers with attention
at position 4, MoE FFNs at the odd positions). The reference stacks the
groups' params on a leading axis and scans over them; here each group is a
module of an ``nn.ModuleList`` and the model loops.

Every layer is pre-norm residual:  x += mixer(norm(x));  x += ffn(norm2(x)).
The MoE FFN's aux loss is summed on the training path and dropped by
prefill and decode, as the reference does. A layer's decode cache is the
attention's {k, v}, Mamba's {h, conv} or RWKV6's {S, x_tmix, x_cmix}, the
last shared by the layer's time-mix and channel-mix.

The per-layer steps (``mixer_full`` / ``_prefill`` / ``_decode``,
``ffn_full`` / ``_decode``, ``cmix_state``) are also the mesh's:
``distributed.parallel`` runs them on each coordinate's blocks and sums
the model shards' deltas.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention, mamba, mlp, moe, rwkv6
from repro_torch.models.common import Policy, rms_norm

_MIXERS = ("attn", "mamba", "rwkv6")
_FFNS = ("dense", "moe", "rwkv_cmix")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.ffn not in _FFNS:
        raise ValueError(f"unknown ffn {spec.ffn!r}")


class Layer(nn.Module):
    """``norm1``, ``norm2`` (d,), ``mixer`` (attention, Mamba or an RWKV6
    time-mix) and ``ffn`` (a dense MLP, an MoE or an RWKV6 channel-mix)."""

    def __init__(self, mixer: nn.Module, ffn: nn.Module, cfg: ArchConfig, policy: Policy,
                 device=None):
        super().__init__()
        kw = dict(dtype=policy.param_dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones((cfg.d_model,), **kw), requires_grad=False)
        self.norm2 = nn.Parameter(torch.ones((cfg.d_model,), **kw), requires_grad=False)
        self.mixer = mixer
        self.ffn = ffn


class Group(nn.Module):
    """One repetition of the layer pattern: submodules ``layer0`` .. ``layer{p-1}``."""

    def __init__(self, layers: list[Layer]):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(f"layer{i}", layer)


def _build_mixer(spec: LayerSpec, cfg: ArchConfig, policy: Policy, device) -> nn.Module:
    if spec.mixer == "mamba":
        return mamba.Mamba(cfg, policy, device)
    if spec.mixer == "rwkv6":
        return rwkv6.TimeMix(cfg, policy, device)
    return attention.Attention(cfg, policy, device)


def _build_ffn(spec: LayerSpec, cfg: ArchConfig, policy: Policy, device) -> nn.Module:
    if spec.ffn == "moe":
        return moe.MoE(cfg, policy, device)
    if spec.ffn == "rwkv_cmix":
        return rwkv6.ChannelMix(cfg, policy, device)
    return mlp.MLP(cfg, policy, device=device)


def _init_mixer(generator, spec: LayerSpec, cfg: ArchConfig, policy: Policy, device):
    if spec.mixer == "mamba":
        return mamba.init(generator, cfg, policy, device)
    if spec.mixer == "rwkv6":
        return rwkv6.init_tmix(generator, cfg, policy, device)
    return attention.init(generator, cfg, policy, device)


def _init_ffn(generator, spec: LayerSpec, cfg: ArchConfig, policy: Policy, device):
    if spec.ffn == "moe":
        return moe.init(generator, cfg, policy, device)
    if spec.ffn == "rwkv_cmix":
        return rwkv6.init_cmix(generator, cfg, policy, device)
    return mlp.init(generator, cfg, policy, device=device)


def build_group(cfg: ArchConfig, policy: Policy, device=None) -> Group:
    """A group with its parameters allocated but not drawn (``init_group`` draws)."""
    layers = []
    for spec in cfg.layer_pattern():
        _check_spec(spec)
        layers.append(Layer(_build_mixer(spec, cfg, policy, device),
                            _build_ffn(spec, cfg, policy, device), cfg, policy, device))
    return Group(layers)


def init_group(generator: torch.Generator, cfg: ArchConfig, policy: Policy,
               device=None) -> Group:
    layers = []
    for spec in cfg.layer_pattern():
        _check_spec(spec)
        mixer = _init_mixer(generator, spec, cfg, policy, device)
        ffn = _init_ffn(generator, spec, cfg, policy, device)
        layers.append(Layer(mixer, ffn, cfg, policy, device))
    return Group(layers)


def init_group_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    cache = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        _check_spec(spec)
        if spec.mixer == "attn":
            c = attention.init_cache(cfg, batch, max_len, dtype, device)
        elif spec.mixer == "mamba":
            c = mamba.init_state(cfg, batch, dtype, device)
        else:  # the rwkv6 state serves both time-mix and channel-mix
            c = rwkv6.init_state(cfg, batch, dtype, device)
        cache[f"layer{i}"] = c
    return cache


def _layers(params: Group, cfg: ArchConfig):
    for i, spec in enumerate(cfg.layer_pattern()):
        yield f"layer{i}", spec, getattr(params, f"layer{i}")


def mixer_full(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               positions: torch.Tensor, heads: attention.Heads | None = None) -> torch.Tensor:
    """The layer's mixer on norm1(x): its delta to x, or with ``heads`` a
    tensor-parallel shard's part of it (``attention.Heads``)."""
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    if spec.mixer == "attn":
        return attention.fwd_full(lp.mixer, cfg, policy, h, positions, heads)
    if spec.mixer == "mamba":
        return mamba.fwd_full(lp.mixer, cfg, policy, h)
    return rwkv6.fwd_tmix_full(lp.mixer, cfg, policy, h)


def mixer_prefill(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                  positions: torch.Tensor,
                  heads: attention.Heads | None = None) -> tuple[torch.Tensor, dict]:
    """``mixer_full`` and the layer's decode cache: the attention's bf16 k,
    v, Mamba's {h, conv}, RWKV6's {S, x_tmix, x_cmix} (x_cmix set by
    ``cmix_state``); h and S f32, the rest bf16, as the reference keeps them."""
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    if spec.mixer == "attn":
        return attention.fwd_prefill(lp.mixer, cfg, policy, h, positions, heads)
    if spec.mixer == "mamba":
        return mamba.fwd_prefill(lp.mixer, cfg, policy, h)
    return rwkv6.fwd_tmix_prefill(lp.mixer, cfg, policy, h)


def mixer_decode(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                 cache: dict, cache_len: int,
                 heads: attention.Heads | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step of the mixer: (delta, cache), the attention cache
    updated in place, an SSM state replaced."""
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    if spec.mixer == "attn":
        return attention.fwd_decode(lp.mixer, cfg, policy, h, cache, cache_len, heads)
    if spec.mixer == "mamba":
        return mamba.fwd_decode(lp.mixer, cfg, policy, h, cache)
    return rwkv6.fwd_tmix_decode(lp.mixer, cfg, policy, h, cache)


def ffn_full(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy,
             x: torch.Tensor) -> tuple[torch.Tensor, tuple | None]:
    """The layer's FFN on norm2(x): (delta, the MoE's aux-loss factors
    (frac, mean_p), else None). The delta is a tensor-parallel shard's part
    when ``lp.ffn`` holds the shard's columns of ``wi`` and rows of ``wo``."""
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    if spec.ffn == "moe":
        out, frac, mean_p = moe.apply_stats(lp.ffn, cfg, policy, h)
        return out, (frac, mean_p)
    if spec.ffn == "rwkv_cmix":
        return rwkv6.fwd_cmix_full(lp.ffn, cfg, policy, h), None
    return mlp.apply(lp.ffn, cfg, policy, h), None


def ffn_decode(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step of the FFN: (delta, cache), RWKV6's channel-mix
    state replaced; the MoE's aux loss dropped, as the reference does."""
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    if spec.ffn == "moe":
        return moe.apply_stats(lp.ffn, cfg, policy, h)[0], cache
    if spec.ffn == "rwkv_cmix":
        return rwkv6.fwd_cmix_decode(lp.ffn, cfg, policy, h, cache)
    return mlp.apply(lp.ffn, cfg, policy, h), cache


def cmix_state(lp: Layer, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor,
               cache: dict) -> None:
    """Prefill: an RWKV6 layer's channel-mix state, norm2(x) at the last
    position, into its cache; nothing for another layer."""
    if spec.ffn == "rwkv_cmix":
        hn = rms_norm(x, lp.norm2, cfg.norm_eps)
        cache["x_cmix"] = hn[:, -1:, :].to(cache["x_cmix"].dtype)


def apply_group_full(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The training path (no cache). Returns (x, aux_loss_sum () f32), the
    aux loss 0 without MoE."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, spec, lp in _layers(params, cfg):
        x = x + mixer_full(lp, spec, cfg, policy, x, positions)
        delta, stats = ffn_full(lp, spec, cfg, policy, x)
        x = x + delta
        if stats is not None:
            aux_total = aux_total + moe.aux_loss(cfg, *stats)
    return x, aux_total


def apply_group_prefill(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                        positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Like full, but collects the decode cache for each layer."""
    cache = {}
    for name, spec, lp in _layers(params, cfg):
        y, c = mixer_prefill(lp, spec, cfg, policy, x, positions)
        x = x + y
        delta, _ = ffn_full(lp, spec, cfg, policy, x)
        cmix_state(lp, spec, cfg, x, c)
        x = x + delta
        cache[name] = c
    return x, cache


def apply_group_decode(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                       cache: dict, cache_len: int) -> tuple[torch.Tensor, dict]:
    """One decode step through the group. x (B, 1, d); the attention caches
    are updated in place, each SSM layer's state replaced in ``cache``."""
    for name, spec, lp in _layers(params, cfg):
        y, c = mixer_decode(lp, spec, cfg, policy, x, cache[name], cache_len)
        x = x + y
        delta, c = ffn_decode(lp, spec, cfg, policy, x, c)
        x = x + delta
        cache[name] = c
    return x, cache
