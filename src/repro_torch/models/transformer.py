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


def _apply_ffn(lp: Layer, spec: LayerSpec, cfg: ArchConfig, policy: Policy,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Returns (delta, aux), aux 0.0 but for an MoE."""
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    if spec.ffn == "moe":
        return moe.apply(lp.ffn, cfg, policy, h)
    if spec.ffn == "rwkv_cmix":
        return rwkv6.fwd_cmix_full(lp.ffn, cfg, policy, h), 0.0
    return mlp.apply(lp.ffn, cfg, policy, h), 0.0


def apply_group_full(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The training path (no cache). Returns (x, aux_loss_sum () f32), the
    aux loss 0 without MoE."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, spec, lp in _layers(params, cfg):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if spec.mixer == "attn":
            x = x + attention.fwd_full(lp.mixer, cfg, policy, h, positions)
        elif spec.mixer == "mamba":
            x = x + mamba.fwd_full(lp.mixer, cfg, policy, h)
        else:
            x = x + rwkv6.fwd_tmix_full(lp.mixer, cfg, policy, h)
        delta, aux = _apply_ffn(lp, spec, cfg, policy, x)
        x = x + delta
        aux_total = aux_total + aux
    return x, aux_total


def _attn_prefill(p: attention.Attention, cfg: ArchConfig, policy: Policy, h: torch.Tensor,
                  positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    q, k, v = attention._project_qkv(p, cfg, policy, h, positions)
    reps = cfg.phys_heads // cfg.num_kv_heads
    out = attention._flash_attention(
        q, attention._repeat_kv(k, reps), attention._repeat_kv(v, reps), cfg.sliding_window)
    mask = attention._head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    y = attention._out_proj(out, policy.cast(p.wo))
    # the cache is bf16 whatever the policy, as the reference keeps it
    return y, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def apply_group_prefill(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                        positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Like full, but collects the decode cache for each layer (the SSM
    states in bf16 but h and S, f32, as the reference keeps them)."""
    cache = {}
    for name, spec, lp in _layers(params, cfg):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if spec.mixer == "attn":
            y, c = _attn_prefill(lp.mixer, cfg, policy, h, positions)
        elif spec.mixer == "mamba":
            y, c = mamba.fwd_prefill(lp.mixer, cfg, policy, h)
        else:
            y, c = rwkv6.fwd_tmix_prefill(lp.mixer, cfg, policy, h)
        x = x + y
        delta, _ = _apply_ffn(lp, spec, cfg, policy, x)
        if spec.ffn == "rwkv_cmix":
            hn = rms_norm(x, lp.norm2, cfg.norm_eps)
            c["x_cmix"] = hn[:, -1:, :].to(c["x_cmix"].dtype)
        x = x + delta
        cache[name] = c
    return x, cache


def apply_group_decode(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                       cache: dict, cache_len: int) -> tuple[torch.Tensor, dict]:
    """One decode step through the group. x (B, 1, d); the attention caches
    are updated in place, each SSM layer's state replaced in ``cache``."""
    for name, spec, lp in _layers(params, cfg):
        c = cache[name]
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if spec.mixer == "attn":
            y, c = attention.fwd_decode(lp.mixer, cfg, policy, h, c, cache_len)
        elif spec.mixer == "mamba":
            y, c = mamba.fwd_decode(lp.mixer, cfg, policy, h, c)
        else:
            y, c = rwkv6.fwd_tmix_decode(lp.mixer, cfg, policy, h, c)
        x = x + y
        h2 = rms_norm(x, lp.norm2, cfg.norm_eps)
        if spec.ffn == "moe":
            x = x + moe.apply(lp.ffn, cfg, policy, h2)[0]
        elif spec.ffn == "rwkv_cmix":
            delta, c = rwkv6.fwd_cmix_decode(lp.ffn, cfg, policy, h2, c)
            x = x + delta
        else:
            x = x + mlp.apply(lp.ffn, cfg, policy, h2)
        cache[name] = c
    return x, cache
