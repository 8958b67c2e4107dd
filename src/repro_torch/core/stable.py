"""APNC-SD (paper Section 7, Alg 4) — SHIM.

The coefficient fit lives in `repro_torch.embed.apnc` (the "sd" member of the
embedding registry); this module keeps the JAX package's call shape, with an
integer seed for its PRNG key. New code should go through
`repro_torch.embed.get_embedding` or the `KernelKMeans(method="sd")` facade.

(Imports are lazy: repro_torch.core is imported by repro_torch.embed at
definition time, so the shim edge back into repro_torch.embed must not run at
module import.)
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.apnc import APNCCoefficients
from repro_torch.core.kernels_fn import Kernel


def fit(seed: int, X: torch.Tensor, kernel: Kernel, l: int, m: int, t: int | None = None,
        q: int = 1) -> APNCCoefficients:
    """Fit APNC-SD coefficients (deprecated shim over repro_torch.embed.apnc.fit_sd;
    bit-exact — it delegates untouched)."""
    warnings.warn(
        "core.stable.fit is deprecated; use repro_torch.embed.apnc.fit_sd "
        "(or KernelKMeans(method='sd')) instead",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.embed.apnc import fit_sd

    return fit_sd(seed, X, kernel, l=l, m=m, t=t, q=q)
