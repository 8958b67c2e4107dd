"""Dense FFN blocks: SwiGLU (llama-family) and GELU (musicgen)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Policy, normal_init, silu


class MLP(nn.Module):
    """Parameters ``wi`` (d, 2 d_ff) for SwiGLU (gate and up fused) or (d, d_ff)
    for GELU, and ``wo`` (d_ff, d); allocated empty, ``init`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, d_ff: int | None = None,
                 device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        width = 2 * f if cfg.act == "swiglu" else f  # fused gate+up projection
        kw = dict(dtype=policy.param_dtype, device=device)
        self.wi = nn.Parameter(torch.empty((d, width), **kw), requires_grad=False)
        self.wo = nn.Parameter(torch.empty((f, d), **kw), requires_grad=False)


def init(generator: torch.Generator, cfg: ArchConfig, policy: Policy,
         d_ff: int | None = None, device=None) -> MLP:
    p = MLP(cfg, policy, d_ff, device)
    dt = policy.param_dtype
    p.wi.copy_(normal_init(generator, p.wi.shape, dt))
    p.wo.copy_(normal_init(generator, p.wo.shape, dt, scale=0.02 / (2 * cfg.num_layers) ** 0.5))
    return p


def apply(p: MLP, cfg: ArchConfig, policy: Policy, x: torch.Tensor) -> torch.Tensor:
    h = x @ policy.cast(p.wi)
    if cfg.act == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        h = silu(gate) * up
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ policy.cast(p.wo)
