"""Kernel functions kappa(., .) used by the paper (Section 9), on torch tensors.

``gram(X, Z) -> K`` with ``K[i, j] = kappa(x_i, z_j)`` for ``X: (n, d)``,
``Z: (l, d)``. This is the plain version the embedding kernel is held against.
"""
from __future__ import annotations

import dataclasses

import torch


def _sq_dists(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (n, l), clamped at 0.

    ||x - z||^2 = ||x||^2 - 2 x'z + ||z||^2: one (n, d) x (d, l) product,
    then every elementwise step in place on it, so a full Gram (n = l =
    50,000: 10 GB in f32) never has a second (n, l) buffer beside it. The
    bits are those of ``clamp(xx - 2 (X Z^T) + zz, 0)``: scaling by -2 is
    exact, and ``(-2p) + xx`` rounds as ``xx - 2p`` does.
    """
    xx = torch.sum(X * X, dim=-1, keepdim=True)  # (n, 1)
    zz = torch.sum(Z * Z, dim=-1, keepdim=True).T  # (1, l)
    return (X @ Z.T).mul_(-2.0).add_(xx).add_(zz).clamp_(min=0.0)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel function with its parameters (hashable, like the reference)."""

    name: str  # "rbf" | "poly" | "tanh" | "linear"
    gamma: float = 1.0  # rbf: exp(-gamma ||x-z||^2)
    degree: int = 5  # poly
    coef0: float = 1.0  # poly / tanh offset
    scale: float = 1.0  # tanh slope a

    def gram(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        """Dense kernel matrix K[i, j] = kappa(X[i], Z[j]); shape (n, l)."""
        if self.name == "rbf":
            return _sq_dists(X, Z).mul_(-self.gamma).exp_()  # in place, as _sq_dists
        if self.name == "poly":
            return (X @ Z.T + self.coef0) ** self.degree
        if self.name == "tanh":
            return torch.tanh(self.scale * (X @ Z.T) + self.coef0)
        if self.name == "linear":
            return X @ Z.T
        raise ValueError(f"unknown kernel {self.name!r}")

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        """kappa(x, x) for each row."""
        if self.name == "rbf":
            return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
        sq = torch.sum(X * X, dim=-1)
        if self.name == "poly":
            return (sq + self.coef0) ** self.degree
        if self.name == "tanh":
            return torch.tanh(self.scale * sq + self.coef0)
        if self.name == "linear":
            return sq
        raise ValueError(f"unknown kernel {self.name!r}")


def self_tuned_rbf(X: torch.Tensor, sample: int = 512, seed: int = 0) -> Kernel:
    """Self-tuning sigma (Section 9): sigma^2 = mean off-diagonal squared
    distance over a sample of rows; gamma = 1 / (2 sigma^2).

    The sample is drawn without replacement by a ``torch.Generator`` seeded
    with ``seed``; it is not the JAX package's draw, so tests that compare the
    two packages pass ``gamma`` in.
    """
    n = X.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(n, generator=gen)[: min(sample, n)].to(X.device)
    S = X[idx].to(torch.float32)
    d2 = _sq_dists(S, S)
    m = d2.shape[0]
    sigma2 = max(float(torch.sum(d2)) / (m * (m - 1)), 1e-12)
    return Kernel("rbf", gamma=float(1.0 / (2.0 * sigma2)))
