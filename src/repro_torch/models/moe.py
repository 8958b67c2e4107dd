"""Mixture-of-Experts FFN: top-k routing with GShard-style grouped dense dispatch.

  * Tokens are routed in groups of ``GROUP_SIZE`` (fewer when the batch has
    fewer tokens); each expert takes at most ``_capacity`` tokens a group,
    by priority (choice, position), and the rest of its assignments are
    dropped.
  * Dispatch and combine are the one-hot einsum pair over (group, choice,
    expert, capacity slot); the experts are SwiGLU FFNs held stacked, ``wi``
    (E, d, 2 f) with gate and up fused, ``wo`` (E, f, d).
  * Shared experts (qwen2-moe) are an always-active fused SwiGLU with a
    learned sigmoid gate.
  * The Switch load-balancing aux loss: E * sum_e frac_tokens_e * mean_prob_e
    over each token's first choice.

The routing's integer bookkeeping (``ids``, ``pos``, ``keep``) equals the
reference's (``src/repro/models/moe.py``): the top k are taken by a stable
descending sort, so equal probabilities go to the lower expert index as
``jax.lax.top_k`` gives them. At S == 1 (decode) the groups form across the
batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Policy, normal_init, silu

GROUP_SIZE = 256
CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    """``router`` (d, E), ``wi`` (E, d, 2 f), ``wo`` (E, f, d) and, with
    shared experts, ``shared_wi`` (d, 2 fs), ``shared_wo`` (fs, d) and
    ``shared_gate`` (d, 1), fs = num_shared * d_ff_shared: the reference's
    layouts. Allocated empty; ``init`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, device=None):
        super().__init__()
        moe = cfg.moe
        d, E, f = cfg.d_model, moe.num_experts, moe.d_ff_expert
        shapes = {"router": (d, E), "wi": (E, d, 2 * f), "wo": (E, f, d)}
        if moe.num_shared:
            fs = moe.num_shared * moe.d_ff_shared
            shapes.update(shared_wi=(d, 2 * fs), shared_wo=(fs, d), shared_gate=(d, 1))
        kw = dict(dtype=policy.param_dtype, device=device)
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw), requires_grad=False))


def init(generator: torch.Generator, cfg: ArchConfig, policy: Policy, device=None) -> MoE:
    p = MoE(cfg, policy, device)
    dt = policy.param_dtype
    out_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    for name, param in p.named_parameters():
        scale = out_scale if name.endswith("wo") else 0.02
        param.copy_(normal_init(generator, param.shape, dt, scale=scale))
    return p


def _capacity(group: int, top_k: int, num_experts: int, factor: float) -> int:
    return max(1, int(group * top_k * factor / num_experts + 0.5))


class Routing(NamedTuple):
    probs: torch.Tensor  # (n, G, E) f32 router softmax
    gates: torch.Tensor  # (n, G, k) f32, the top-k probabilities renormalized
    ids: torch.Tensor    # (n, G, k) int64 expert of each choice
    pos: torch.Tensor    # (n, G, k) int64 slot in the expert's buffer
    keep: torch.Tensor   # (n, G, k) bool: pos < capacity
    capacity: int


def route(p: MoE, cfg: ArchConfig, policy: Policy, xg: torch.Tensor) -> Routing:
    """Top-k routing of grouped tokens xg (n, G, d) and the GShard
    position-in-expert bookkeeping, priority (choice, position)."""
    moe = cfg.moe
    E, k = moe.num_experts, moe.top_k
    C = _capacity(xg.shape[1], k, E, CAPACITY_FACTOR)
    logits = torch.einsum("ngd,de->nge", xg, policy.cast(p.router)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: ties go to the lower index, as in lax.top_k
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)

    # rank of each (token, choice) among the group's assignments to the same
    # expert = same-choice earlier tokens + all assignments of earlier choices
    onehot = F.one_hot(ids, E)  # (n, G, k, E) int64
    counts = torch.sum(onehot, dim=1, keepdim=True)  # (n, 1, k, E)
    offset = torch.cumsum(counts, dim=2) - counts
    pos_in_e = (torch.cumsum(onehot, dim=1) - onehot) + offset
    pos = torch.sum(pos_in_e * onehot, dim=-1)
    return Routing(probs, gates, ids, pos, pos < C, C)


def aux_loss(cfg: ArchConfig, frac: torch.Tensor, mean_p: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss from each expert's share of first
    choices ``frac`` (E,) and its mean router probability ``mean_p`` (E,)."""
    E = cfg.moe.num_experts
    return cfg.moe.aux_loss_weight * E * torch.sum(frac * mean_p)


def apply(p: MoE, cfg: ArchConfig, policy: Policy,
          x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss () f32)."""
    out, frac, mean_p = apply_stats(p, cfg, policy, x)
    return out, aux_loss(cfg, frac, mean_p)


def apply_stats(p: MoE, cfg: ArchConfig, policy: Policy, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), frac (E,), mean_p (E,)): ``apply`` with
    the aux loss's two factors in its place, so that a data-parallel caller
    can average them over its shards before their product. The experts'
    ``wi`` / ``wo`` may be a tensor-parallel shard's columns / rows (the
    gate and up halves of each), and ``out`` is then that shard's partial sum."""
    moe = cfg.moe
    B, S, d = x.shape
    E = moe.num_experts
    T = B * S
    G = min(GROUP_SIZE, T)
    xg = x.reshape(T // G, G, d)
    r = route(p, cfg, policy, xg)

    # dispatch / combine (n, G, k, E, C): the GShard einsum pair
    cdt = policy.compute_dtype
    onehot = F.one_hot(r.ids, E).to(cdt)
    pos_oh = F.one_hot(torch.clamp(r.pos, max=r.capacity - 1), r.capacity).to(cdt)
    pos_oh = pos_oh * r.keep[..., None].to(cdt)
    disp = onehot[..., None] * pos_oh[..., None, :]
    comb = disp * r.gates.to(cdt)[..., None, None]

    expert_in = torch.einsum("ngkec,ngd->necd", disp, xg)  # (n, E, C, d)
    h = torch.einsum("necd,edf->necf", expert_in, policy.cast(p.wi))
    gate_h, up_h = torch.chunk(h, 2, dim=-1)
    h = silu(gate_h) * up_h
    expert_out = torch.einsum("necf,efd->necd", h, policy.cast(p.wo))
    out = torch.einsum("ngkec,necd->ngd", comb, expert_out).reshape(B, S, d)

    frac = torch.mean(F.one_hot(r.ids[:, :, 0], E).to(torch.float32), dim=(0, 1))  # (E,)
    mean_p = torch.mean(r.probs, dim=(0, 1))

    if moe.num_shared:
        g, u = torch.chunk(x @ policy.cast(p.shared_wi), 2, dim=-1)
        shared = (silu(g) * u) @ policy.cast(p.shared_wo)
        sg = torch.sigmoid((x @ policy.cast(p.shared_gate)).to(torch.float32))
        out = out + shared * sg.to(out.dtype)
    return out, frac, mean_p
