"""Layer-group assembly, the dense-attention subset. A "group" is one repetition
of the arch's layer pattern (length p; dense archs p = 1: [attn + ffn]). The
reference stacks the groups' params on a leading axis and scans over them;
here each group is a module of an ``nn.ModuleList`` and the model loops.

Every layer is pre-norm residual:  x += mixer(norm(x));  x += ffn(norm2(x)).

Mamba and RWKV6 mixers and MoE / RWKV channel-mix FFNs are not ported: they
raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item 15.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention, mlp
from repro_torch.models.common import Policy, rms_norm

_NOT_PORTED = ("the {} {} is not ported yet (ROADMAP.md Queue 1 item 15: the LM "
               "substrate's MoE, Mamba and RWKV6 layers)")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(_NOT_PORTED.format(spec.mixer, "mixer"))
    if spec.ffn != "dense":
        raise NotImplementedError(_NOT_PORTED.format(spec.ffn, "ffn"))


class Layer(nn.Module):
    """``norm1``, ``norm2`` (d,), ``mixer`` (attention) and ``ffn`` (dense MLP)."""

    def __init__(self, mixer: attention.Attention, ffn: mlp.MLP, cfg: ArchConfig,
                 policy: Policy, device=None):
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


def build_group(cfg: ArchConfig, policy: Policy, device=None) -> Group:
    """A group with its parameters allocated but not drawn (``init_group`` draws)."""
    layers = []
    for spec in cfg.layer_pattern():
        _check_spec(spec)
        layers.append(Layer(attention.Attention(cfg, policy, device),
                            mlp.MLP(cfg, policy, device=device), cfg, policy, device))
    return Group(layers)


def init_group(generator: torch.Generator, cfg: ArchConfig, policy: Policy,
               device=None) -> Group:
    layers = []
    for spec in cfg.layer_pattern():
        _check_spec(spec)
        mixer = attention.init(generator, cfg, policy, device)
        ffn = mlp.init(generator, cfg, policy, device=device)
        layers.append(Layer(mixer, ffn, cfg, policy, device))
    return Group(layers)


def init_group_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    cache = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        _check_spec(spec)
        cache[f"layer{i}"] = attention.init_cache(cfg, batch, max_len, dtype, device)
    return cache


def _layers(params: Group, cfg: ArchConfig):
    for i, spec in enumerate(cfg.layer_pattern()):
        _check_spec(spec)
        yield f"layer{i}", getattr(params, f"layer{i}")


def _apply_ffn(lp: Layer, cfg: ArchConfig, policy: Policy, x: torch.Tensor) -> torch.Tensor:
    return mlp.apply(lp.ffn, cfg, policy, rms_norm(x, lp.norm2, cfg.norm_eps))


def apply_group_full(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, float]:
    """No cache. Returns (x, aux_loss_sum), the aux loss 0 without MoE."""
    for _, lp in _layers(params, cfg):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        x = x + attention.fwd_full(lp.mixer, cfg, policy, h, positions)
        x = x + _apply_ffn(lp, cfg, policy, x)
    return x, 0.0


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
    """Like full, but collects the decode cache for each layer."""
    cache = {}
    for name, lp in _layers(params, cfg):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        y, cache[name] = _attn_prefill(lp.mixer, cfg, policy, h, positions)
        x = x + y
        x = x + _apply_ffn(lp, cfg, policy, x)
    return x, cache


def apply_group_decode(params: Group, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                       cache: dict, cache_len: int) -> tuple[torch.Tensor, dict]:
    """One decode step through the group. x (B, 1, d); the cache is updated in place."""
    for name, lp in _layers(params, cfg):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        y, cache[name] = attention.fwd_decode(lp.mixer, cfg, policy, h, cache[name], cache_len)
        x = x + y
        x = x + _apply_ffn(lp, cfg, policy, x)
    return x, cache
