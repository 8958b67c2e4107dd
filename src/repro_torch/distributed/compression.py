"""Gradient compression for the data-parallel all-reduce: int8 quantization with
error feedback (EF-SGD style).

Each data shard quantizes its raw gradient (plus its carried residual) to
int8 against a per-leaf max-abs scale; the int8 codes are summed as int32
and the scales summed, in shard order on the first shard's device
(`launch.mesh.cross_device_sum`, one ``reduce.cross_device`` count a step);
the mean is dequantized with the mean scale, and each shard's quantization
residual is carried to its next step (error feedback keeps the bias
bounded). As in the reference, the parameters are replicated (classic DDP)
and the batch is split over the data axes, in one process over the mesh's
devices.

Wire saving: 1 byte a gradient element instead of 4 on the data-parallel
all-reduce.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import cross_device_sum


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    raise TypeError(f"cannot map over {type(first).__name__}")


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), like)


def init_error_state(grads_like: Any) -> Any:
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                     grads_like)


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the f32 scale max|g| / 127 (at least 1e-12): g divided
    by the scale (not multiplied by its reciprocal), rounded half to even,
    clipped to +-127 — the reference's bits."""
    scale = torch.amax(torch.abs(g)) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads: list, errors: list, devices) -> tuple[list, list]:
    """Over the data shards: ``grads[s]`` and ``errors[s]`` are shard s's
    gradient and residual trees, on ``devices[s]``. Returns (the mean
    gradient tree on each shard's device, each shard's new residual)."""
    n = len(devices)
    quant, recon = [], []
    for g_tree, e_tree in zip(grads, errors):
        parts, mine = [], []
        for g, e in zip(_leaves(g_tree), _leaves(e_tree)):
            g32 = g.to(torch.float32) + e
            q, scale = _quantize(g32)
            parts.append((q.to(torch.int32), scale))
            mine.append((g32, q, scale))
        quant.append(parts)
        recon.append(mine)
    totals = cross_device_sum(quant, devices)  # int32 codes and scales, shard order
    mean = []
    for total, scale_sum in totals:
        # each shard contributed q_i * scale_i; dequantizing with the mean scale
        # is exact when the scales match and bounded otherwise — the residual
        # goes back into the error feedback
        mean_scale = scale_sum / n
        mean.append(total.to(torch.float32) * mean_scale / n)
    like = grads[0]
    means = [_unflatten(like, [x.to(dev) for x in mean]) for dev in devices]
    new_err = [_unflatten(like, [g32 - q.to(torch.float32) * scale for g32, q, scale in mine])
               for mine in recon]
    return means, new_err


def make_ddp_compressed_step(mesh, loss_fn: Callable, opt_update: Callable, axes=("data",)):
    """DDP train step with int8-EF gradient exchange.

    params are REPLICATED (classic DDP), the batch split over ``axes``.
    loss_fn: (params, batch) -> scalar (the shard's mean). opt_update:
    (params, grads, opt_state) -> (params, opt_state). Returns
    step(params, opt_state, err, batch) -> (params, opt_state, err, loss):
    ``err`` is one residual tree a data shard (a single tree is every
    shard's initial residual), params and the loss on the first shard's
    device.
    """
    devices = []  # one a coordinate of ``axes``, row-major, the other axes at 0
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        pos = dict(zip(axes, idx))
        devices.append(mesh.devices[tuple(pos.get(a, 0) for a in mesh.axis_names)])
    n = len(devices)

    def step(params, opt_state, err, batch):
        if not isinstance(err, list):
            err = [_tree_map(lambda e, d=d: e.to(d), err) for d in devices]
        B = batch.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} data shards")
        rows = torch.chunk(batch, n, dim=0)
        losses, grads = [], []
        for dev, xb in zip(devices, rows):
            p = _tree_map(lambda t: t.detach().to(dev).requires_grad_(True), params)
            loss = loss_fn(p, xb.to(dev))
            leaves = _leaves(p)
            grads.append(_unflatten(p, list(torch.autograd.grad(loss, leaves))))
            losses.append(loss.detach())
        loss = cross_device_sum(losses, devices) / n
        means, err = compressed_psum(grads, err, devices)
        params, opt_state = opt_update(params, means[0], opt_state)
        return params, opt_state, err, loss

    return step
