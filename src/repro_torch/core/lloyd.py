"""Lloyd iterations on APNC embeddings (paper Algorithm 2), single-program form.

  * the iteration is a Python loop with one host sync per iteration, for the
    "did any label change" test;
  * empty clusters keep their previous centroid, as a MapReduce reducer that
    receives no values for key c does;
  * init is k-means++ under the declared discrepancy e, in embedding space.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.apnc import Discrepancy, pairwise_discrepancy
from repro_torch.policy import ComputePolicy, as_policy


def block_cost(Y: torch.Tensor, centroids: torch.Tensor, discrepancy: Discrepancy) -> torch.Tensor:
    """Sum of min e(y_i, c) over a row batch: the inertia contribution of one
    block, the one definition every driver reports inertia with."""
    return torch.sum(torch.min(pairwise_discrepancy(Y, centroids, discrepancy), dim=-1).values)


class LloydResult(NamedTuple):
    labels: torch.Tensor  # (n,) int32
    centroids: torch.Tensor  # (k, m)
    inertia: torch.Tensor  # () sum of e(y_i, c_{pi(i)})
    iters: int  # iterations actually run
    costs: torch.Tensor | None = None  # (iters,) inertia of iteration i's assignment
    shifts: torch.Tensor | None = None  # (iters,) ||c_{i+1} - c_i||_F of each update


def centroid_update(Z: torch.Tensor, g: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Y_bar = Z / g, with empty clusters keeping their previous centroid."""
    return torch.where((g > 0)[:, None], Z / torch.clamp(g, min=1.0)[:, None], prev)


def assign_stats(
    Y: torch.Tensor, centroids: torch.Tensor, k: int, discrepancy: Discrepancy,
    policy: ComputePolicy | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-centroid labels (int32) under e plus the (Z, g) sufficient
    statistics for one row batch: the assign kernel where
    ``policy.resolve_kernels(Y.device)`` (by default: CUDA tensors), else its
    plain version on Y's device."""
    from repro_torch.kernels import ops, ref

    if centroids.shape[0] != k:
        raise ValueError(f"k={k} does not match {centroids.shape[0]} centroids")
    if not as_policy(policy).resolve_kernels(Y.device):
        return ref.apnc_assign_ref(Y.to(torch.float32), centroids.to(torch.float32),
                                   discrepancy)
    return ops.apnc_assign(Y, centroids, discrepancy)


#: Bytes of exponentials a seeding draws and copies at once: a whole-Y
#: seeding (n up to millions) takes its draws in chunks of this size.
E_CHUNK_BYTES = 64 << 20


def _exponentials(generator: torch.Generator, draws: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """(draws, n) float64 Exp(1) values on ``device``, row by row from
    ``generator`` as ``torch.multinomial(p, 1)`` draws them (one (n,)
    ``exponential_`` a call), so the generator is consumed as by that many
    calls; staged in pinned memory and copied once without a wait."""
    on_card = device.type == "cuda"
    E = torch.empty((draws, n), dtype=torch.float64, pin_memory=on_card)
    for row in E:
        row.exponential_(1, generator=generator)
    return E.to(device, non_blocking=True) if on_card else E


def kmeanspp_init(
    generator: torch.Generator, Y: torch.Tensor, k: int, discrepancy: Discrepancy,
    policy: ComputePolicy | None = None,
) -> torch.Tensor:
    """k-means++ seeding in embedding space with D(x)^2 weighting under e.

    ``generator`` is a CPU ``torch.Generator``: the first row comes from
    ``randint``, then the exponentials of all k - 1 draws, so the same seed
    picks the same rows on any device, the rows ``torch.multinomial`` picks
    draw by draw (``ref.kmeanspp_seed_ref`` holds the rule; D(x) in float64
    from the rows' differences). The picks are made on Y's device without a
    wait: by the ``kmeanspp_seed`` kernel where ``policy.resolve_kernels``
    and the pool fits a cluster's shared memory, else by the plain version
    (exponentials in chunks of ``E_CHUNK_BYTES``). One wait at the end reads
    whether a draw found every weight 0 (fewer than k distinct rows), and
    raises RuntimeError as ``multinomial`` does. Traced, the draws, their
    copy and the picks' launch are one ``seed.draws`` span (attrs ``draws``,
    ``route``: ``kernel`` or ``plain``; its seconds also go to the
    ``span.seed.draws`` histogram).
    """
    from repro_torch.kernels import kmeanspp, ref

    n, m = Y.shape
    first = int(torch.randint(0, n, (1,), generator=generator))
    card = (as_policy(policy).resolve_kernels(Y.device) and Y.dtype == torch.float32
            and kmeanspp.cluster_size(n, m) > 0)
    with obs.span("seed.draws", cat="seed", observe=True, draws=k - 1,
                  route="kernel" if card else "plain"):
        if card:
            E = _exponentials(generator, k - 1, n, Y.device)
            _, centroids, bad = kmeanspp.kmeanspp_seed(Y.contiguous(), E, first, discrepancy)
        else:
            step = max(1, E_CHUNK_BYTES // (8 * n))
            chunks = (_exponentials(generator, min(step, k - i), n, Y.device)
                      for i in range(1, k, step))
            _, centroids, bad = ref.kmeanspp_seed_ref(Y, chunks, first, k, discrepancy)
    if bool(bad):
        raise RuntimeError("invalid multinomial distribution (sum of probabilities <= 0): "
                           f"k-means++ found fewer than k={k} distinct rows")
    return centroids


def lloyd(
    Y: torch.Tensor,
    k: int,
    *,
    discrepancy: Discrepancy,
    iters: int = 20,
    generator: torch.Generator | None = None,
    init: torch.Tensor | None = None,
    policy: ComputePolicy | None = None,
) -> LloydResult:
    """Run up to ``iters`` Lloyd iterations of Algorithm 2 on embeddings Y (n, m).

    Stops at a label fixed point, then assigns once more under the final
    centroids (the loop's labels lag one update) through the same plan.
    """
    if init is None:
        if generator is None:
            raise ValueError("provide generator= for k-means++ init or init= centroids")
        init = kmeanspp_init(generator, Y, k, discrepancy, policy)

    from repro_torch.kernels import ops

    plan = ops.lloyd_step_plan(discrepancy=discrepancy, policy=policy)
    centroids = init
    labels = torch.full((Y.shape[0],), -1, dtype=torch.int32, device=Y.device)
    costs, shifts = [], []
    it = 0
    changed = True
    while it < iters and changed:
        Z, g, new_labels, cost = plan.step(Y, centroids)
        new_centroids = centroid_update(Z, g, centroids)
        costs.append(cost)
        shifts.append(torch.linalg.norm(new_centroids - centroids))
        changed = bool(torch.any(new_labels != labels))  # the one host sync
        centroids, labels = new_centroids, new_labels
        it += 1
    labels, inertia = plan.assign(Y, centroids)
    empty = torch.zeros((0,), dtype=torch.float32, device=Y.device)
    costs = torch.stack(costs) if costs else empty
    shifts = torch.stack(shifts) if shifts else empty
    return LloydResult(labels, centroids, inertia, it, costs, shifts)
