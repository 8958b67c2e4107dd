"""GPipe-style pipeline parallelism over a "pipe" mesh axis.

An opt-in layout for deeper scaling (pipe x data x model), as in the
reference: stage s's parameters live on the device at pipe coordinate s,
microbatches stream through the stages on the classic fill / steady /
drain schedule, with (P - 1) bubble slots for M microbatches. The
reference runs it as a ``shard_map`` whose scan rotates the activations
with ``ppermute``; the port runs the same ticks in one process over the
mesh's devices (stage s takes microbatch m at tick t = s + m), copying each
activation from stage s's device to stage s + 1's, and autograd runs
through the copies as JAX's does through the rotation and the scan.
"""
from __future__ import annotations

from typing import Callable

import torch


def _index(tree, s: int, device):
    if isinstance(tree, torch.Tensor):
        return tree[s].to(device)
    if isinstance(tree, dict):
        return {k: _index(v, s, device) for k, v in tree.items()}
    return type(tree)(_index(v, s, device) for v in tree)


def pipelined_apply(mesh, stage_fn: Callable, params_stacked, x_micro: torch.Tensor,
                    axis: str = "pipe") -> torch.Tensor:
    """Run x through all stages in pipeline order. Returns (M, mb, ...) outputs
    on ``x_micro``'s device.

    stage_fn: (stage_params, x) -> x; params_stacked: a tree whose leaves have
    a leading dim of n_stages (stage s's slice goes to pipe coordinate s);
    x_micro: (M, mb, ...) microbatched activations.
    """
    n_stages = mesh.shape[axis]
    ax = mesh.axis_names.index(axis)
    devs = [mesh.devices[tuple(s if a == ax else 0 for a in range(len(mesh.axis_names)))]
            for s in range(n_stages)]
    M = x_micro.shape[0]
    stage_params = [_index(params_stacked, s, devs[s]) for s in range(n_stages)]
    inbox: list = [None] * n_stages  # the activation waiting at each stage
    outs: list = [None] * M
    for t in range(M + n_stages - 1):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < M:
                continue  # a bubble slot
            x_in = x_micro[m].to(devs[0]) if s == 0 else inbox[s]
            y = stage_fn(stage_params[s], x_in)
            if s == n_stages - 1:
                outs[m] = y.to(x_micro.device)
            else:
                nxt[s + 1] = y.to(devs[s + 1])  # rotate stage s -> s + 1
        inbox = nxt
    return torch.stack(outs)
