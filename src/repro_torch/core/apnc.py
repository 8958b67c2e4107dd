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
    """One block of Algorithm 1: X (n, d), L_b (l_b, d), R_b (m_b, l_b) -> (n, m_b).

    On the CPU an f32 block is computed in f64 and rounded once: the f32
    GEMMs' rounding there changes with the BLAS kernel that the thread count
    selects, and R's large entries (Lambda^-1/2 of a gram with small
    eigenvalues) carry it into Y (1.7e-4 at |Y| = 6 for sd / poly at 4
    threads). On a card the f32 GEMMs stay, as the kernels' yardstick.
    """
    if X.device.type == "cpu" and X.dtype == torch.float32:
        f64 = torch.float64
        return (kernel.gram(X.to(f64), landmarks_b.to(f64)) @ R_b.to(f64).T).to(X.dtype)
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
    footprint at O(n * m) instead of O(n * m * k). On the CPU the l2 cross
    term is one matrix-vector product per centroid, each against a fresh
    copy of it, so a column's values do not depend on where the centroid
    sits in C: a GEMM's rounding does (a k-column product rounds its edge
    columns otherwise), and with it the inertia of one partition under two
    numberings. On a card the GEMM stays.
    """
    if discrepancy == "l2":
        yy = torch.sum(Y * Y, dim=-1, keepdim=True)  # (n, 1)
        cc = torch.sum(C * C, dim=-1)[None, :]  # (1, k)
        if Y.device.type == "cpu":
            yc = torch.stack([torch.mv(Y, c.clone()) for c in C], dim=1)
        else:
            yc = Y @ C.T
        return torch.sqrt(torch.clamp(yy - 2.0 * yc + cc, min=0.0))
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
    """The paper's (Z, g): per-cluster embedding sums (k, m) and counts (k,).

    On the CPU ``index_add_`` adds each cluster's rows in row order, so Z[c]
    does not depend on the index c the cluster carries: the one-hot GEMM's
    rounding does (by the column a cluster lands in), and with it the
    inertia of one partition under two numberings, which decides between
    restarts that reach it. On a card the one-hot GEMM stays, as the
    kernels' yardstick.
    """
    labels = labels.long()
    if Y.device.type == "cpu":
        Z = torch.zeros((k, Y.shape[1]), dtype=Y.dtype).index_add_(0, labels, Y)
        return Z, torch.bincount(labels, minlength=k).to(Y.dtype)
    onehot = torch.nn.functional.one_hot(labels, k).to(Y.dtype)  # (n, k)
    return onehot.T @ Y, torch.sum(onehot, dim=0)
