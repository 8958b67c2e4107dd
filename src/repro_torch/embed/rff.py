"""Random Fourier features as a member of the embedding family ("rff").

Rahimi-Recht features for the RBF kernel exp(-gamma ||x - z||^2):

    z(x) = sqrt(1/m) [cos(x W), sin(x W)],   W ~ N(0, 2 gamma I)  (d, m)

E[<z(x), z(x')>] = kappa(x, x'), so plain k-means on z(X) approximates kernel
k-means. The member is landmark-free (the fit is a data-independent draw;
only d is read from the data) and declares e = l2, q = 1. W is drawn from a
``torch.Generator`` seeded with the fit's seed, so it is not the JAX
package's draw: tests hand the JAX package's W over through
``repro_torch.convert.rff_params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed.base import Embedding, register_embedding
from repro_torch.kernels.ref import rff_embed_ref


@dataclasses.dataclass
class RFFParams:
    """The fitted RFF map: the frequency matrix W (gamma absorbed into the
    draw) and the approximated kernel."""

    W: torch.Tensor  # (d, m_half); the output dim is 2 * m_half ([cos, sin])
    kernel: Kernel

    @property
    def m(self) -> int:  # total embedding dimensionality
        return 2 * self.W.shape[1]

    @property
    def d(self) -> int:  # input dimensionality
        return self.W.shape[0]

    @property
    def discrepancy(self) -> str:
        return "l2"

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.W.shape[1])

    @property
    def device(self) -> torch.device:
        return self.W.device

    def to(self, device) -> "RFFParams":
        """The same params with W on ``device``."""
        return dataclasses.replace(self, W=self.W.to(device))


def rff_transform(params: RFFParams, X: torch.Tensor) -> torch.Tensor:
    """The plain map: (n, d) -> (n, 2 m_half) f32 in the [cos, sin] layout."""
    return rff_embed_ref(X, params.W, params.scale)


@register_embedding
class RFFEmbedding(Embedding):
    name = "rff"
    params_cls = RFFParams

    def fit(self, seed, data, kernel, *, l, m, t=None, q=1) -> RFFParams:
        """Draw W for m cosine features (output dim 2m) from a CPU generator
        seeded with ``seed``. ``l`` and ``t`` are knobs of the kernelized
        members and are ignored; q > 1 is not defined for this member."""
        if kernel.name != "rbf":
            raise ValueError(
                "the rff embedding approximates shift-invariant kernels; got "
                f"kernel {kernel.name!r} (use method='nystrom'/'sd' for "
                "other kernels)"
            )
        if q != 1:
            raise ValueError("rff is not blockwise; q must be 1")
        if m < 1:
            raise ValueError(f"m must be >= 1, got {m}")
        gen = torch.Generator().manual_seed(int(seed))
        W = torch.randn((data.shape[-1], m), generator=gen) * math.sqrt(2.0 * kernel.gamma)
        return RFFParams(W=W.to(data.device), kernel=kernel)

    def transform(self, params: RFFParams, X: torch.Tensor) -> torch.Tensor:
        return rff_transform(params, X)

    def kernel_transform(self, params: RFFParams, X: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.rff_embed(X, params)
