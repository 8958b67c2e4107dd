"""Public wrappers over the hand-written kernels, and the Y-mode Lloyd step plan.

The CUDA kernels mask ragged edges themselves, so nothing here pads: there
are no lane-multiple copies of X and no sentinel centroid rows. Routing
follows the tensor: CUDA tensors reach the kernels, CPU tensors their plain
PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.apnc import APNCCoefficients
from repro_torch.kernels import apnc_assign as _assign
from repro_torch.kernels import apnc_embed as _embed
from repro_torch.policy import ComputePolicy, as_policy


def apnc_embed(X: torch.Tensor, coeffs: APNCCoefficients) -> torch.Tensor:
    """Fused APNC embedding over all q blocks: X (n, d) -> Y (n, q * m_b) f32.
    Each block's kernel writes straight into its column slice of Y."""
    n = X.shape[0]
    m_b = coeffs.R.shape[1]
    Y = torch.empty((n, coeffs.q * m_b), dtype=torch.float32, device=X.device)
    landmarks = coeffs.landmarks.to(torch.float32)
    R = coeffs.R.to(torch.float32)
    X = X.contiguous()
    for b in range(coeffs.q):
        _embed.apnc_embed_block(
            X, landmarks[b].contiguous(), R[b].contiguous(), coeffs.kernel,
            out=Y[:, b * m_b:(b + 1) * m_b],
        )
    return Y


def apnc_assign(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assignment + sufficient stats: Y (n, m), C (k, m) -> Z (k, m) f32,
    g (k,) f32, labels (n,) int32."""
    return _assign.apnc_assign(
        Y.to(torch.float32).contiguous(), C.to(torch.float32).contiguous(), discrepancy
    )


def embed_block_map(x: torch.Tensor, params, *, policy: ComputePolicy | None = None):
    """Block-shaped embedding entry: one routed transform of a (rows, d) block
    for any registered embedding's params."""
    from repro_torch import embed  # the one routing point for every member

    return embed.transform(params, x, as_policy(policy))


def _assign_stats_cost_y(y: torch.Tensor, centroids: torch.Tensor, discrepancy: str):
    from repro_torch.core.lloyd import assign_stats, block_cost

    Z, g, labels = assign_stats(y, centroids, centroids.shape[0], discrepancy)
    return Z, g, labels, block_cost(y, centroids, discrepancy)


class LloydStepPlan:
    """One Lloyd block step, resolved once and shared by the drivers.

        step(block, centroids)   -> (Z, g, labels, cost)   # stats convention
        assign(block, centroids) -> (labels, cost)          # final-pass form

    This slice ports the Y-mode plan: ``block`` is an already-embedded
    (rows, m) block, as on the local backend. Z, g and labels come from the
    assign kernel (or its plain version on the CPU) and the cost from
    ``block_cost``. The X-mode plan and the fused Lloyd-step kernels arrive
    with the stream backend.
    """

    def __init__(self, *, discrepancy: str):
        self.discrepancy = discrepancy

    def step(self, block: torch.Tensor, centroids: torch.Tensor):
        """(Z, g, labels, cost) for one embedded block under ``centroids``."""
        return _assign_stats_cost_y(block, centroids, self.discrepancy)

    def assign(self, block: torch.Tensor, centroids: torch.Tensor):
        """(labels, cost) for one embedded block: the final / scoring pass."""
        _, _, labels, cost = _assign_stats_cost_y(block, centroids, self.discrepancy)
        return labels, cost


def lloyd_step_plan(discrepancy: str) -> LloydStepPlan:
    """Build the Y-mode plan for embedded blocks under ``discrepancy``."""
    return LloydStepPlan(discrepancy=discrepancy)
