"""AdamW over named parameters, built from scratch as the reference builds it.

  * moments are stored in a configurable dtype (``bfloat16`` for the 100B+
    configs so the optimizer state fits device memory); the update math is
    always float32;
  * global-norm gradient clipping;
  * decoupled weight decay, skipped for leaves with ``ndim <= 1`` in the
    reference's params tree. That tree stacks an LM's layer groups on a
    leading axis, so a layer's norm scale is (G, d) there and is decayed;
    the port's groups are unstacked (``groups.<g>.`` names), and a leaf
    under them counts the stacked axis too (``_tree_ndim``). Only the final
    norm escapes decay, as in the reference.

``params`` is an ``nn.Module`` (its ``named_parameters()``) or a dict of
tensors by name; ``grads`` and the moments are dicts keyed by the same
names. The reference returns new trees; here ``update`` writes the new
parameters and moments into the given tensors in place, under
``torch.no_grad()``, and returns them with the new step. The per-leaf
arithmetic is the reference's (``src/repro/optim/adamw.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4  # peak; the schedule multiplies it
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"  # "bfloat16" for >=100B params


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the CPU
    mu: dict            # first moment by parameter name
    nu: dict            # second moment by parameter name


def named(params) -> dict[str, torch.Tensor]:
    """The parameters by name: a module's ``named_parameters()``, or the dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _tree_ndim(name: str, leaf: torch.Tensor) -> int:
    """The leaf's ndim in the reference's params tree, whose LM layer groups
    are stacked on a leading axis."""
    return leaf.ndim + 1 if name.startswith("groups.") else leaf.ndim


def _no_decay(name: str, leaf: torch.Tensor) -> bool:
    """1D leaves of the reference's tree are not decayed."""
    return _tree_ndim(name, leaf) <= 1


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.moments_dtype)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in named(params).items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros())


def global_norm(tree: dict) -> torch.Tensor:
    """The norm of every leaf together, on the first leaf's device (the
    leaves of a device mesh's blocks may lie on several)."""
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()]
    dev = leaves[0].device
    return torch.sqrt(torch.sum(torch.stack([x.to(dev) for x in leaves])))


@torch.no_grad()
def update(params, grads: dict, state: AdamWState, cfg: AdamWConfig,
           lr_scale: float = 1.0):
    """Returns (params, new_state, metrics ``{"grad_norm", "lr"}``), the
    parameters and moments updated in place. Math in f32, storage in the
    declared dtypes; params keep their dtype."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = np.float32(int(step))  # the bias corrections in f32, as the reference takes them
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    mdt = getattr(torch, cfg.moments_dtype)

    for name, p in named(params).items():
        mu, nu = state.mu[name], state.nu[name]
        c = clip.to(p.device) if isinstance(clip, torch.Tensor) else clip
        g32 = grads[name].to(torch.float32) * c
        mu32 = b1 * mu.to(torch.float32) + (1 - b1) * g32
        nu32 = b2 * nu.to(torch.float32) + (1 - b2) * g32 * g32
        upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if cfg.weight_decay and not _no_decay(name, p):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
        mu.copy_(mu32.to(mdt))
        nu.copy_(nu32.to(mdt))

    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
    return params, AdamWState(step, state.mu, state.nu), metrics
