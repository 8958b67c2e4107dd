"""Distributed APNC over a device mesh: the MapReduce programs of the paper
(Algorithms 1 + 2) over a row-sharded resident X, in one process.

Mapping:
  * data blocks on mappers    -> X / Y split into D contiguous row shards, one
                                 per data-axis device of the mesh (`shard_rows`)
  * broadcast of (R, L)       -> the embedding params on every shard's device
  * map-only embedding job    -> a shard-local `embed.transform`, no reduction
  * in-mapper combiner (Z, g) -> shard-local sufficient statistics
  * shuffle of (Z, g)         -> ONE `cross_device_sum` of k * (m + 1) floats a
                                 shard per Lloyd iteration
  * single reducer Y_bar      -> `centroid_update` once on the first shard's
                                 device, replicated to the others

The JAX package checks its two communication claims on the lowered HLO (an
embedding with no collective, a Lloyd iteration that moves only (Z, g)); the
port has no HLO, and counts its reductions instead (the ``reduce.cross_device``
counter of `repro_torch.obs`): none in `distributed_embed`, one an
iteration in `distributed_lloyd`, plus one for the costs with
``return_costs``. A row shard is a view of X where the shard's device is X's
own, so logical shards on one card copy nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apnc import Discrepancy
from repro_torch.core.lloyd import assign_stats, centroid_update
from repro_torch.device import on_device
from repro_torch.kernels import ops
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.launch.mesh import cross_device_sum, replicate, shard_devices


def data_axes_of(mesh) -> tuple[str, ...]:
    """The axes APNC shards rows over: every mesh axis but ``"model"`` (the
    APNC programs have no tensor-parallel dimension)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def shard_rows(mesh, X: torch.Tensor) -> list[torch.Tensor]:
    """X split into D contiguous row shards, shard d on the mesh's data device
    d. Raises when n does not divide the data extent."""
    devices = shard_devices(mesh)
    D = len(devices)
    n = int(X.shape[0])
    if n % D:
        raise ValueError(
            f"shard_map backend needs n ({n}) divisible by the mesh's data extent ({D}); "
            "pad the input or pick another backend")
    step = n // D
    return [X[d * step:(d + 1) * step].to(dev) for d, dev in enumerate(devices)]


def _shards(mesh, X) -> list[torch.Tensor]:
    return list(X) if isinstance(X, (list, tuple)) else shard_rows(mesh, X)


def distributed_embed(mesh, X, params, *, policy: ComputePolicy | None = None
                      ) -> list[torch.Tensor]:
    """Algorithm 1 over the mesh, for any registered embedding member: each
    row shard of X (a tensor, split by `shard_rows`, or the list of shards)
    embeds through `embed.transform` under the policy, on its own device
    (the member's kernel on a card). Map-only: no reduction. Returns the Y
    shards in shard order."""
    from repro_torch import embed

    pol = as_policy(policy)
    shards = _shards(mesh, X)
    out = []
    for x in shards:
        with on_device(x.device):
            out.append(embed.transform(params.to(x.device), x, pol))
    return out


def _lloyd_shards(mesh, Y, init_centroids, *, k, discrepancy, iters, policy, costs_too):
    """The Lloyd loop of `distributed_lloyd`: (labels, centroids, per-shard
    per-iteration cost stacks or None) with the labels still per shard."""
    pol = as_policy(policy)
    Ys = _shards(mesh, Y)
    devices = [y.device for y in Ys]
    plan = ops.lloyd_step_plan(discrepancy=discrepancy, policy=pol)
    c = init_centroids.to(devices[0], torch.float32)
    c_locals = replicate(c, devices)
    local_costs: list[list[torch.Tensor]] = [[] for _ in Ys]
    for _ in range(iters):
        stats = []
        for d, y in enumerate(Ys):
            with on_device(y.device):
                if costs_too:
                    Z, g, _, cost = plan.step(y, c_locals[d])
                    local_costs[d].append(cost)
                else:
                    Z, g, _ = assign_stats(y, c_locals[d], k, discrepancy, policy=pol)
            stats.append((Z, g))
        Z, g = cross_device_sum(stats, devices)  # the only communication
        c = centroid_update(Z, g, c)
        c_locals = replicate(c, devices)
    labels = []
    for d, y in enumerate(Ys):
        with on_device(y.device):
            labels.append(ops.assign_labels(y, c_locals[d], discrepancy, pol).to(torch.int32))
    stacks = None
    if costs_too:
        empty = [torch.zeros((0,), device=dev) for dev in devices]
        stacks = [torch.stack(cs) if cs else e for cs, e in zip(local_costs, empty)]
    return labels, c, stacks


def distributed_lloyd(
    mesh,
    Y,
    init_centroids: torch.Tensor,
    *,
    k: int,
    discrepancy: Discrepancy,
    iters: int = 20,
    policy: ComputePolicy | None = None,
    return_costs: bool = False,
):
    """Algorithm 2 over the mesh. Every iteration, each shard
      map:     assigns its rows to the nearest centroid under e (Eq. 4),
      combine: accumulates Z (k, m) and g (k,) locally,
    then the shards' (Z, g) are summed once (the only communication) and
    Y_bar = Z / g is computed once and replicated. The loop runs the whole
    ``iters`` budget, as the JAX package's ``fori_loop`` does.

    ``Y`` is a tensor (split by `shard_rows`) or the list of row shards.
    Returns (labels (n,) int32, centroids (k, m)), both on the first shard's
    device; with ``return_costs=True`` also the (iters,) global inertia of
    each iteration's assignment under its pre-update centroids. Those costs
    stay per shard through the loop and are reduced once after it.
    """
    labels, c, stacks = _lloyd_shards(mesh, Y, init_centroids, k=k, discrepancy=discrepancy,
                                      iters=iters, policy=policy, costs_too=return_costs)
    dev0 = c.device
    labels = torch.cat([lab.to(dev0) for lab in labels])
    if not return_costs:
        return labels, c
    costs = cross_device_sum(stacks, [s.device for s in stacks])
    return labels, c, costs


def sample_rows_global(generator: torch.Generator, X, count: int) -> torch.Tensor:
    """A uniform sample of ``count`` rows drawn without replacement from the
    CPU ``generator``, gathered across the row shards of X (a tensor or the
    list of shards) onto the first shard's device, in draw order."""
    shards = list(X) if isinstance(X, (list, tuple)) else [X]
    sizes = [int(s.shape[0]) for s in shards]
    idx = torch.randperm(sum(sizes), generator=generator)[:count]
    offsets = np.cumsum([0] + sizes)
    dev0 = shards[0].device
    out = torch.empty((int(idx.shape[0]), shards[0].shape[1]), dtype=shards[0].dtype,
                      device=dev0)
    for d, s in enumerate(shards):
        mask = (idx >= int(offsets[d])) & (idx < int(offsets[d + 1]))
        if bool(mask.any()):
            rows = s[(idx[mask] - int(offsets[d])).to(s.device)]
            out[mask.to(dev0)] = rows.to(dev0)
    return out


def distributed_fit_predict(mesh, seed: int, X, kernel, k: int, cfg=None):
    """End-to-end distributed embed-and-conquer:

    1. fit the coefficients on X with the fit seed of ``phase1_seeds(seed)``
       (the landmark sample and the small eigensolve, replicated),
    2. Algorithm 1 over the row shards (map-only),
    3. k-means++ on a global sample of min(n, 16 k) embedded rows, both drawn
       from ``restart_generator(seed_seed, 0)``,
    4. Algorithm 2 with one (Z, g) reduction an iteration.

    Returns (labels (n,) int32, centroids, params), the labels and centroids
    on the first shard's device.
    """
    from repro_torch.api.estimator import phase1_seeds, restart_generator
    from repro_torch.core.kkmeans import APNCConfig, fit_coefficients
    from repro_torch.core.lloyd import kmeanspp_init

    cfg = cfg or APNCConfig()
    _, s_fit, s_seed = phase1_seeds(seed)
    shards = _shards(mesh, X)
    whole = X if isinstance(X, torch.Tensor) else torch.cat([s.to(shards[0].device)
                                                             for s in shards])
    coeffs = fit_coefficients(s_fit, whole, kernel, cfg)
    Y = distributed_embed(mesh, shards, coeffs, policy=cfg.compute)
    gen = restart_generator(s_seed, 0)
    sample = sample_rows_global(gen, Y, min(sum(int(y.shape[0]) for y in Y), 16 * k))
    c0 = kmeanspp_init(gen, sample, k, coeffs.discrepancy, cfg.compute)
    labels, centroids = distributed_lloyd(mesh, Y, c0, k=k, discrepancy=coeffs.discrepancy,
                                          iters=cfg.iters, policy=cfg.compute)
    return labels, centroids, coeffs
