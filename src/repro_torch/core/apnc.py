"""APNC embedding family (paper Section 4), on torch tensors.

An APNC embedding is ``y = R @ K_{L, i}``. ``APNCCoefficients`` carries the q
diagonal blocks as stacked tensors (q, l_b, d) / (q, m_b, l_b), so q = 1 and
q > 1 share one code path. The functions here are the plain versions; the
hand-written CUDA kernels live in ``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.kernels_fn import Kernel

Discrepancy = Literal["l2", "l1"]


@dataclasses.dataclass
class APNCCoefficients:
    """The (R, L) pair of Property 4.2/4.3, in block form.

    landmarks: (q, l_b, d)   -- the q disjoint landmark subsets L^(b)
    R:         (q, m_b, l_b) -- the q diagonal blocks of the coefficients matrix
    """

    landmarks: torch.Tensor
    R: torch.Tensor
    kernel: Kernel
    discrepancy: Discrepancy

    @property
    def q(self) -> int:
        return self.landmarks.shape[0]

    @property
    def m(self) -> int:  # total embedding dimensionality
        return self.R.shape[0] * self.R.shape[1]

    @property
    def l(self) -> int:  # total number of landmarks
        return self.landmarks.shape[0] * self.landmarks.shape[1]

    @property
    def d(self) -> int:  # input dimensionality
        return self.landmarks.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.landmarks.device

    def to(self, device) -> "APNCCoefficients":
        """The same coefficients with their tensors on ``device``."""
        return dataclasses.replace(
            self, landmarks=self.landmarks.to(device), R=self.R.to(device)
        )


def embed_block(
    X: torch.Tensor, landmarks_b: torch.Tensor, R_b: torch.Tensor, kernel: Kernel
) -> torch.Tensor:
    """One block of Algorithm 1: X (n, d), L_b (l_b, d), R_b (m_b, l_b) -> (n, m_b)."""
    return kernel.gram(X, landmarks_b) @ R_b.T


def embed(X: torch.Tensor, coeffs: APNCCoefficients) -> torch.Tensor:
    """Full APNC embedding Y = f(X): (n, d) -> (n, q * m_b), blocks concatenated."""
    parts = [
        embed_block(X, coeffs.landmarks[b], coeffs.R[b], coeffs.kernel)
        for b in range(coeffs.q)
    ]
    return torch.cat(parts, dim=-1)


def pairwise_discrepancy(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy
) -> torch.Tensor:
    """e(y_i, c_j) for all pairs: Y (n, m), C (k, m) -> (n, k).

    l2 is the sqrt'd inner-product expansion; l1 goes per centroid to keep the
    footprint at O(n * m) instead of O(n * m * k).
    """
    if discrepancy == "l2":
        yy = torch.sum(Y * Y, dim=-1, keepdim=True)  # (n, 1)
        cc = torch.sum(C * C, dim=-1)[None, :]  # (1, k)
        return torch.sqrt(torch.clamp(yy - 2.0 * (Y @ C.T) + cc, min=0.0))
    if discrepancy == "l1":
        cols = [torch.sum(torch.abs(Y - c[None, :]), dim=-1) for c in C]
        return torch.stack(cols, dim=1)
    raise ValueError(f"unknown discrepancy {discrepancy!r}")


def assign(Y: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy) -> torch.Tensor:
    """Approximate assignment step, Eq. (4): argmin_c e(y_i, c), int64."""
    return torch.argmin(pairwise_discrepancy(Y, C, discrepancy), dim=-1)


def sufficient_stats(
    Y: torch.Tensor, labels: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's (Z, g): per-cluster embedding sums (k, m) and counts (k,)."""
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(Y.dtype)  # (n, k)
    return onehot.T @ Y, torch.sum(onehot, dim=0)
