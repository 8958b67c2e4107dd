"""The two APNC members of the paper, on the Embedding protocol.

  * "nystrom" (Section 6, Algorithm 3): R = Lambda_m^{-1/2} V_m^T from the
    rank-m eigendecomposition of K_LL; e = l2.
  * "sd" (Section 7, Algorithm 4): p-stable directions in the whitened kernel
    space of the centered landmark gram; e = l1 (Eq. 13).

Both share ``APNCCoefficients`` and one transform: ``core.apnc.embed`` as the
plain version, the hand-written ``apnc_embed`` kernel on the card.
``torch.linalg.eigh`` (ascending, like ``jnp.linalg.eigh``) runs outside any
kernel, on whatever device the landmarks are on.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.apnc import APNCCoefficients, embed
from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed.base import Embedding, EmbeddingProps, register_embedding

_EIG_EPS = 1e-8
_EIG_RCOND = 1e-6  # relative to the top eigenvalue, pinv-style


def _inv_sqrt_clamped(lam: torch.Tensor) -> torch.Tensor:
    """1/sqrt(lam) with tiny or negative eigenvalues zeroed. The cutoff is
    relative to the top eigenvalue (lam is ascending) plus an absolute floor,
    so roundoff eigenvalues of a rank-deficient gram are dropped instead of
    amplified."""
    eps = max(_EIG_EPS, _EIG_RCOND * max(float(lam[-1]), 0.0))
    return torch.where(lam > eps, torch.rsqrt(torch.clamp(lam, min=eps)),
                       torch.zeros_like(lam))


def sample_landmarks(generator: torch.Generator, X: torch.Tensor, l: int) -> torch.Tensor:
    """Uniform sample of l rows without replacement (Algorithm 3's map phase);
    ``generator`` is a CPU generator, so the rows depend only on its seed."""
    idx = torch.randperm(X.shape[0], generator=generator)[:l]
    return X[idx.to(X.device)]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


# ------------------------------------------------------------------- nystrom


def _nystrom_block(landmarks: torch.Tensor, kernel: Kernel, m: int) -> torch.Tensor:
    """R^(b) = Lambda_m^{-1/2} V_m^T for one block, (m, l_b)."""
    lam, V = torch.linalg.eigh(kernel.gram(landmarks, landmarks))
    inv_sqrt = _inv_sqrt_clamped(lam)[-m:]  # top-m: eigh is ascending
    return inv_sqrt[:, None] * V[:, -m:].T


def fit_nystrom(
    seed: int, X: torch.Tensor, kernel: Kernel, l: int, m: int, q: int = 1,
) -> APNCCoefficients:
    """Fit APNC-Nys coefficients: l landmarks in total, embedding dim q * m."""
    if l % q:
        raise ValueError(f"l={l} must be divisible by q={q}")
    l_b = l // q
    if m > l_b:
        raise ValueError(f"m={m} must be <= landmarks-per-block {l_b}")
    landmarks = sample_landmarks(_gen(seed), X, l).reshape(q, l_b, X.shape[-1])
    landmarks = landmarks.to(torch.float32)
    R = torch.stack([_nystrom_block(landmarks[b], kernel, m) for b in range(q)])
    return APNCCoefficients(landmarks=landmarks, R=R, kernel=kernel, discrepancy="l2")


# ------------------------------------------------------------------------ sd


def _centered_gram(landmarks: torch.Tensor, kernel: Kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """(H K H, H): the landmarks' gram centered by H = I - 11^T / l, made
    exactly symmetric, and H."""
    l = landmarks.shape[0]
    dev = landmarks.device
    H = torch.eye(l, device=dev) - torch.full((l, l), 1.0 / l, device=dev)
    G = H @ kernel.gram(landmarks, landmarks) @ H
    return 0.5 * (G + G.T), H


def _sd_directions(generator: torch.Generator, m: int, l: int, t: int) -> torch.Tensor:
    """S (m, l) on the host: row r has ones at the first t entries of the
    r-th ``randperm(l)`` that ``generator`` draws, zeros elsewhere."""
    S = torch.zeros((m, l))
    for r in range(m):
        S[r, torch.randperm(l, generator=generator)[:t]] = 1.0
    return S


def _sd_block(
    generator: torch.Generator, landmarks: torch.Tensor, kernel: Kernel, m: int, t: int,
) -> torch.Tensor:
    """Algorithm 4 for one block: whiten the centered gram, sum random
    t-subsets of whitening rows, re-center, scale by 1/sqrt(t). Traced, the
    draws of S, its one copy to the landmarks' device and the product are
    one ``sd.directions`` span (its seconds also go to the
    ``span.sd.directions`` histogram)."""
    G, H = _centered_gram(landmarks, kernel)
    lam, V = torch.linalg.eigh(G)
    E = _inv_sqrt_clamped(lam)[:, None] * V.T  # (l, l)
    with obs.span("sd.directions", cat="phase", observe=True, m=m, t=t):
        S = _sd_directions(generator, m, landmarks.shape[0], t).to(landmarks.device)
        return ((S @ E) @ H) / (float(t) ** 0.5)


def fit_sd(
    seed: int, X: torch.Tensor, kernel: Kernel, l: int, m: int,
    t: int | None = None, q: int = 1,
) -> APNCCoefficients:
    """Fit APNC-SD coefficients. Default t = 40% of l per the paper."""
    if l % q:
        raise ValueError(f"l={l} must be divisible by q={q}")
    l_b = l // q
    t = max(1, int(round(0.4 * l_b))) if t is None else t
    if not 1 <= t <= l_b:
        raise ValueError(f"t={t} must be in [1, {l_b}]")
    gen = _gen(seed)
    landmarks = sample_landmarks(gen, X, l).reshape(q, l_b, X.shape[-1])
    landmarks = landmarks.to(torch.float32)
    R = torch.stack([_sd_block(gen, landmarks[b], kernel, m, t) for b in range(q)])
    return APNCCoefficients(landmarks=landmarks, R=R, kernel=kernel, discrepancy="l1")


# ------------------------------------------------------------ family members


class _APNCBase(Embedding):
    """Shared transform, kernel path and props of the two (R, L) members."""

    params_cls = APNCCoefficients

    def transform(self, params: APNCCoefficients, X: torch.Tensor) -> torch.Tensor:
        return embed(X, params)

    def kernel_transform(self, params: APNCCoefficients, X: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.apnc_embed(X, params)

    def props(self, params: APNCCoefficients) -> EmbeddingProps:
        return EmbeddingProps(
            # y = R K_{L, i} is linear in the kernel representation always
            # (P4.1 proper); it is linear in the input exactly when kappa is.
            linear=params.kernel.name == "linear",
            discrepancy=params.discrepancy,
            blockwise=True,
            landmark_free=self.landmark_free,
        )


@register_embedding
class NystromEmbedding(_APNCBase):
    name = "nystrom"

    def fit(self, seed, data, kernel, *, l, m, t=None, q=1):
        return fit_nystrom(seed, data, kernel, l=l, m=m, q=q)


@register_embedding
class SDEmbedding(_APNCBase):
    name = "sd"

    def fit(self, seed, data, kernel, *, l, m, t=None, q=1):
        return fit_sd(seed, data, kernel, l=l, m=m, t=t, q=q)
