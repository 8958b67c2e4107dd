"""Baselines the paper compares against (Sections 8-9, Table 2). All
centralized, as in the paper's experiments: they exist to validate the APNC
claims, not to scale.

  * exact_kernel_kmeans   — Lloyd in kernel space via Eq. (2) on the full gram.
  * approx_kkm            — Chitta et al. [7]: centroids restricted to span(Phi_L).
  * rff_kmeans            — Chitta et al. [8] via random Fourier features [29].
  * svd_rff_kmeans        — SV-RFF: k-means on top singular vectors of the RFF map.
  * two_stage             — cluster an l-sample exactly, propagate labels (Table 3
                            sanity baseline).

Each public function draws from CPU ``torch.Generator``s seeded from its
integer ``seed`` (so the draws, and the labels, do not depend on the device)
and hands them to a private helper that holds the arithmetic
(``_exact_lloyd``, ``_approx_lloyd``, ``_vector_lloyd``, ``_propagate``), so
the arithmetic can be held against the JAX package from its own draws. The
functions run on the device of their tensor inputs. The large products
(``K @ M``, ``D.T @ M``, ``Z @ C.T``) are plain f32 ``torch.matmul``s, as the
JAX package computes them outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.nystrom import sample_landmarks


class ClusterResult(NamedTuple):
    labels: torch.Tensor  # (n,) int32
    objective: torch.Tensor  # () sum of the chosen d2


def _seeds(seed: int, count: int) -> list[int]:
    """``count`` independent integer seeds from one root seed."""
    return [int(c.generate_state(1)[0]) for c in np.random.SeedSequence(int(seed)).spawn(count)]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _random_labels(seed: int, n: int, k: int, device) -> torch.Tensor:
    return torch.randint(0, k, (n,), generator=_gen(seed)).to(device)


def _choice(seed: int, n: int, size: int, device) -> torch.Tensor:
    """``size`` distinct row indices of ``n``, uniformly."""
    return torch.randperm(n, generator=_gen(seed))[:size].to(device)


def _onehot_mean(labels: torch.Tensor, k: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    A = torch.nn.functional.one_hot(labels.long(), k).to(dtype)  # (n, k)
    n_c = torch.sum(A, dim=0)  # (k,)
    M = A / torch.clamp(n_c, min=1.0)[None, :]  # column-normalized membership
    return M, n_c


def _result(d2: torch.Tensor, labels: torch.Tensor) -> ClusterResult:
    obj = torch.sum(torch.gather(d2, 1, labels.long()[:, None]))
    return ClusterResult(labels.to(torch.int32), obj)


# ------------------------------------------------------------------- exact


def _exact_d2(K: torch.Tensor, diag: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """d2(i, c) = diag_i - 2 (K M)_ic + (M^T K M)_cc under ``labels``."""
    M, _ = _onehot_mean(labels, k, K.dtype)
    KM = K @ M  # (n, k)
    cc = torch.sum(M * KM, dim=0)  # diag(M^T K M)
    return diag[:, None] - 2.0 * KM + cc[None, :]


def _exact_lloyd(K: torch.Tensor, diag: torch.Tensor, labels0: torch.Tensor, k: int,
                 iters: int) -> tuple[ClusterResult, torch.Tensor]:
    """``iters`` Eq. (2) Lloyd steps from ``labels0`` (no early stop, as in the
    JAX package's fori_loop), then the objective under the final labels.
    Also returns the distances the final labels are the argmin of."""
    labels, d2 = labels0, None
    for _ in range(iters):
        d2 = _exact_d2(K, diag, labels, k)
        labels = torch.argmin(d2, dim=-1)
    final = _exact_d2(K, diag, labels, k)
    return _result(final, labels), final if d2 is None else d2


def exact_kernel_kmeans(seed: int, K: torch.Tensor, diag: torch.Tensor, k: int,
                        iters: int = 20) -> ClusterResult:
    """Lloyd on the full kernel matrix K (n, n) using the Eq. (2) expansion:

      d2(i, c) = K_ii - 2/n_c sum_{a in P_c} K_ia + 1/n_c^2 sum_{a,b in P_c} K_ab
               = diag_i - 2 (K M)_{ic} + (M^T K M)_{cc}

    O(n^2) per iteration / O(n^2) memory — the bottleneck the paper removes.
    """
    return _exact_lloyd(K, diag, _random_labels(seed, K.shape[0], k, K.device), k, iters)[0]


# ------------------------------------------------------------- approx (akkm)


def _pinv(A: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``jnp.linalg.pinv``: singular values at or below
    10 * max(rows, cols) * eps times the largest are dropped (torch's default
    cutoff is ten times smaller)."""
    rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return torch.linalg.pinv(A, rtol=rtol)


def _approx_d2(D, A, A_inv, diag, labels, k) -> torch.Tensor:
    """d2(i, c) = K_ii - 2 D_i alpha_c + alpha_c^T A alpha_c, alpha = A^-1 D^T M."""
    M, _ = _onehot_mean(labels, k, D.dtype)
    alpha = A_inv @ (D.T @ M)  # (l, k)
    quad = torch.sum(alpha * (A @ alpha), dim=0)
    return diag[:, None] - 2.0 * (D @ alpha) + quad[None, :]


def _approx_lloyd(D: torch.Tensor, A: torch.Tensor, A_inv: torch.Tensor, diag: torch.Tensor,
                  labels0: torch.Tensor, k: int, iters: int) -> tuple[ClusterResult, torch.Tensor]:
    """``iters`` steps of the approximate kernel k-means of [7] from
    ``labels0``, then the objective under the final labels. Also returns the
    distances the final labels are the argmin of."""
    labels, d2 = labels0, None
    for _ in range(iters):
        d2 = _approx_d2(D, A, A_inv, diag, labels, k)
        labels = torch.argmin(d2, dim=-1)
    final = _approx_d2(D, A, A_inv, diag, labels, k)
    return _result(final, labels), final if d2 is None else d2


def _approx_inputs(seed, X, kernel, k, l) -> tuple[torch.Tensor, ...]:
    """(D, A, A_inv, diag, labels0) of `approx_kkm` from its seed. A_inv is
    the pseudo-inverse of K_LL + 1e-6 I at the JAX package's cutoff, which
    on rbf grams can sit inside the spectrum: it bounds, and so allows, an
    amplification of roundoff by up to 1 / (10 l eps)."""
    s_land, s_init = _seeds(seed, 2)
    L = sample_landmarks(_gen(s_land), X, l)
    A = kernel.gram(L, L)
    A_inv = _pinv(A + 1e-6 * torch.eye(l, dtype=A.dtype, device=A.device))
    D = kernel.gram(X, L)  # (n, l)
    return D, A, A_inv, kernel.diag(X), _random_labels(s_init, X.shape[0], k, X.device)


def _approx_kkm(seed, X, kernel, k, l, iters) -> tuple[ClusterResult, torch.Tensor]:
    return _approx_lloyd(*_approx_inputs(seed, X, kernel, k, l), k, iters)


def approx_kkm(seed: int, X: torch.Tensor, kernel: Kernel, k: int, l: int,
               iters: int = 20) -> ClusterResult:
    """Approximate kernel k-means of [7]: each centroid is Phi_L alpha_c.

      d2(i, c) = K_ii - 2 D_i alpha_c + alpha_c^T A alpha_c,
      alpha    = A^{-1} D^T M        (least-squares centroid update)

    with D = kappa(X, L) (n, l) and A = K_LL (l, l). O(nlk) per iteration.
    """
    return _approx_kkm(seed, X, kernel, k, l, iters)[0]


# ------------------------------------------------------------------- rff


def rff_features(seed: int, X: torch.Tensor, gamma: float, m: int) -> torch.Tensor:
    """Random Fourier features for the RBF kernel exp(-gamma ||x-z||^2), in
    the [cos, sin] convention (m cosine features -> 2m dims): the "rff"
    embedding member's W drawn from ``seed``, through its plain map."""
    from repro_torch.embed.rff import RFFEmbedding, rff_transform

    params = RFFEmbedding().fit(seed, X, Kernel("rbf", gamma=float(gamma)), l=0, m=m)
    return rff_transform(params, X)


def _vector_d2(Z: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    zz = torch.sum(Z * Z, dim=-1, keepdim=True)
    return zz - 2.0 * Z @ C.T + torch.sum(C * C, dim=-1)[None, :]


def _vector_lloyd(Z: torch.Tensor, C0: torch.Tensor, k: int,
                  iters: int) -> tuple[ClusterResult, torch.Tensor]:
    """``iters`` plain Lloyd steps on explicit features Z (n, f) from the
    centroids ``C0`` (an empty cluster keeps its centroid), then the final
    assignment and objective, and the distances of that assignment."""
    C = C0
    for _ in range(iters):
        labels = torch.argmin(_vector_d2(Z, C), dim=-1)
        A = torch.nn.functional.one_hot(labels, k).to(Z.dtype)
        cnt = torch.sum(A, dim=0)
        newC = (A.T @ Z) / torch.clamp(cnt, min=1.0)[:, None]
        C = torch.where((cnt > 0)[:, None], newC, C)
    d2 = _vector_d2(Z, C)
    return _result(d2, torch.argmin(d2, dim=-1)), d2


def _vector_kmeans(seed: int, Z: torch.Tensor, k: int, iters: int) -> ClusterResult:
    """Plain k-means (Lloyd) on explicit features Z (n, f), seeded by k
    distinct random rows."""
    return _vector_lloyd(Z, Z[_choice(seed, Z.shape[0], k, Z.device)], k, iters)[0]


def _top_singular_directions(Z: torch.Tensor, k: int) -> torch.Tensor:
    """Z V_k: Z projected on the top-k right singular vectors, from the
    (2m, 2m) gram Z^T Z, never n x n. Each column's sign is free."""
    _, V = torch.linalg.eigh(Z.T @ Z)
    return Z @ V[:, -k:]


def _rff(seed, X, gamma, k, m, iters, svd: bool) -> tuple[ClusterResult, torch.Tensor]:
    s_feat, s_init = _seeds(seed, 2)
    Z = rff_features(s_feat, X, gamma, m)
    if svd:
        Z = _top_singular_directions(Z, k)
    return _vector_lloyd(Z, Z[_choice(s_init, Z.shape[0], k, Z.device)], k, iters)


def rff_kmeans(seed: int, X: torch.Tensor, gamma: float, k: int, m: int = 500,
               iters: int = 20) -> ClusterResult:
    """RFF baseline of [8] (shift-invariant kernels only)."""
    return _rff(seed, X, gamma, k, m, iters, svd=False)[0]


def svd_rff_kmeans(seed: int, X: torch.Tensor, gamma: float, k: int, m: int = 500,
                   iters: int = 20) -> ClusterResult:
    """SV-RFF of [8]: k-means on the top-k left singular vectors of the RFF map."""
    return _rff(seed, X, gamma, k, m, iters, svd=True)[0]


# ------------------------------------------------------------- two-stage


def _propagate(K_XS: torch.Tensor, K_SS: torch.Tensor, diag_X: torch.Tensor,
               labels_S: torch.Tensor, k: int) -> tuple[ClusterResult, torch.Tensor]:
    """1-NN-centroid label propagation: d2(i, c) = K_ii - 2/n_c sum_{a in P_c}
    kappa(x_i, s_a) + const_c, against the sample's clusters. Also returns
    the distances."""
    M, _ = _onehot_mean(labels_S, k, K_SS.dtype)
    cc = torch.sum(M * (K_SS @ M), dim=0)
    d2 = diag_X[:, None] - 2.0 * (K_XS @ M) + cc[None, :]
    return _result(d2, torch.argmin(d2, dim=-1)), d2


def _two_stage(seed, X, kernel, k, l, iters) -> tuple[ClusterResult, torch.Tensor]:
    s_sample, s_cluster = _seeds(seed, 2)
    S = X[_choice(s_sample, X.shape[0], l, X.device)]
    K_SS = kernel.gram(S, S)
    res = exact_kernel_kmeans(s_cluster, K_SS, kernel.diag(S), k, iters)
    return _propagate(kernel.gram(X, S), K_SS, kernel.diag(X), res.labels, k)


def two_stage(seed: int, X: torch.Tensor, kernel: Kernel, k: int, l: int,
              iters: int = 20) -> ClusterResult:
    """Table 3 baseline: exact kernel k-means on an l-sample, then 1-NN-centroid
    label propagation to the rest using kernel distances to the sample clusters."""
    return _two_stage(seed, X, kernel, k, l, iters)[0]


def _final_d2(name: str, seed: int, X: torch.Tensor, kernel: Kernel, k: int, *, l: int = 0,
              m: int = 0, iters: int = 20) -> torch.Tensor:
    """The distances whose argmin is baseline ``name``'s final labels for
    this ``seed`` and data (the run replayed): what a comparison of two runs
    reads to tell a near tie from a real difference."""
    if name == "exact_kernel_kmeans":
        labels0 = _random_labels(seed, X.shape[0], k, X.device)
        return _exact_lloyd(kernel.gram(X, X), kernel.diag(X), labels0, k, iters)[1]
    if name == "approx_kkm":
        return _approx_kkm(seed, X, kernel, k, l, iters)[1]
    if name in ("rff_kmeans", "svd_rff_kmeans"):
        return _rff(seed, X, kernel.gamma, k, m, iters, svd=name == "svd_rff_kmeans")[1]
    if name == "two_stage":
        return _two_stage(seed, X, kernel, k, l, iters)[1]
    raise ValueError(f"unknown baseline {name!r}")
