"""APNC-Nys (paper Section 6, Alg 3) — SHIM.

The coefficient fit lives in `repro_torch.embed.apnc` (the "nystrom" member
of the embedding registry); this module keeps the JAX package's call shape,
with an integer seed for its PRNG key. New code should go through
`repro_torch.embed.get_embedding` or the `KernelKMeans(method="nystrom")`
facade.

(Imports are lazy: repro_torch.core is imported by repro_torch.embed at
definition time, so the shim edge back into repro_torch.embed must not run at
module import.)
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.apnc import APNCCoefficients
from repro_torch.core.kernels_fn import Kernel


def sample_landmarks(generator: torch.Generator, X: torch.Tensor, l: int) -> torch.Tensor:
    """Uniform landmark sample (shim over repro_torch.embed.apnc.sample_landmarks)."""
    from repro_torch.embed.apnc import sample_landmarks as _sample

    return _sample(generator, X, l)


def fit(seed: int, X: torch.Tensor, kernel: Kernel, l: int, m: int,
        q: int = 1) -> APNCCoefficients:
    """Fit APNC-Nys coefficients (deprecated shim over
    repro_torch.embed.apnc.fit_nystrom; bit-exact — it delegates untouched)."""
    warnings.warn(
        "core.nystrom.fit is deprecated; use repro_torch.embed.apnc.fit_nystrom "
        "(or KernelKMeans(method='nystrom')) instead",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.embed.apnc import fit_nystrom

    return fit_nystrom(seed, X, kernel, l=l, m=m, q=q)
