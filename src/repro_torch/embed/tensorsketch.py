"""TensorSketch as a member of the embedding family ("tensorsketch").

Pham-Pagh count-sketch of the degree-p tensor product: for the polynomial
kernel (x'z + c)^p,

    ts(x) = ifft( prod_{i=1..p} fft( CountSketch_i(x~) ) ),   x~ = [x, sqrt(c)]

with p independent count-sketches (hash h_i: [d] -> [m], sign s_i: [d] -> ±1),
so that E[<ts(x), ts(z)>] = (x'z + c)^p. The member is landmark-free and
declares e = l2, q = 1.

The count-sketches are stored dense, S (p, d~, m) with S[i, j, h_i(j)] =
s_i(j), so each level's sketch is one matmul and the params serialize as one
array. The member has no hand-written kernel (neither has the JAX package's
a Pallas one): ``embed.transform`` takes its plain version on the tensor's
device, and its Lloyd step is the un-fused route, this map then
``apnc_assign``. S is drawn from a ``torch.Generator`` seeded with the fit's
seed, so it is not the JAX package's draw: tests hand the JAX package's S
over through ``repro_torch.convert.tensorsketch_params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed.base import Embedding, EmbeddingProps, register_embedding


@dataclasses.dataclass
class TensorSketchParams:
    """The fitted sketch: p dense count-sketch matrices over the (possibly
    constant-augmented) input, and the polynomial kernel."""

    S: torch.Tensor  # (p, d_aug, m), exactly one ±1 entry per (level, input) row
    kernel: Kernel

    @property
    def m(self) -> int:  # embedding dimensionality
        return self.S.shape[2]

    @property
    def d(self) -> int:  # input dimensionality (before the constant column)
        return self.S.shape[1] - (1 if self.kernel.coef0 > 0 else 0)

    @property
    def discrepancy(self) -> str:
        return "l2"

    @property
    def device(self) -> torch.device:
        return self.S.device

    def to(self, device) -> "TensorSketchParams":
        """The same params with S on ``device``."""
        return dataclasses.replace(self, S=self.S.to(device))


def tensorsketch_transform(params: TensorSketchParams, X: torch.Tensor) -> torch.Tensor:
    """The plain map: (n, d) -> (n, m) f32. The FFTs run in f32 whatever the
    input's precision, as in the JAX package."""
    if params.kernel.coef0 > 0:  # (x~'z~) = x'z + c
        const = torch.full((X.shape[0], 1), math.sqrt(params.kernel.coef0),
                           dtype=X.dtype, device=X.device)
        X = torch.cat([X, const], dim=-1)
    C = torch.einsum("nd,pdm->pnm", X, params.S.to(X.dtype))  # p count-sketches
    F = torch.prod(torch.fft.fft(C.to(torch.float32), dim=-1), dim=0)
    return torch.fft.ifft(F).real.to(torch.float32)


@register_embedding
class TensorSketchEmbedding(Embedding):
    name = "tensorsketch"
    params_cls = TensorSketchParams
    landmark_free = True
    kernel_families = ("poly",)

    def fit(self, seed, data, kernel, *, l, m, t=None, q=1) -> TensorSketchParams:
        """Draw the p count-sketches for the kernel (x'z + coef0)^degree from a
        CPU generator seeded with ``seed``. ``l`` and ``t`` are knobs of the
        kernelized members and are ignored."""
        if kernel.name != "poly":
            raise ValueError(
                "the tensorsketch embedding targets polynomial kernels; got "
                f"kernel {kernel.name!r} (use method='rff' for rbf, "
                "'nystrom'/'sd' for arbitrary kernels)"
            )
        if q != 1:
            raise ValueError("tensorsketch is not blockwise; q must be 1")
        if m < 1 or kernel.degree < 1:
            raise ValueError(f"need m >= 1 and degree >= 1, got {m}, {kernel.degree}")
        if kernel.coef0 < 0:
            raise ValueError(
                f"tensorsketch needs coef0 >= 0 (the constant augments x as "
                f"sqrt(coef0)), got {kernel.coef0}"
            )
        d_aug = data.shape[-1] + (1 if kernel.coef0 > 0 else 0)
        gen = torch.Generator().manual_seed(int(seed))
        eye = torch.eye(m)
        levels = []
        for _ in range(kernel.degree):
            h = torch.randint(0, m, (d_aug,), generator=gen)
            s = torch.randint(0, 2, (d_aug,), generator=gen).to(torch.float32) * 2.0 - 1.0
            levels.append(s[:, None] * eye[h])  # (d_aug, m), one ±1 per row
        return TensorSketchParams(S=torch.stack(levels).to(data.device), kernel=kernel)

    def transform(self, params: TensorSketchParams, X: torch.Tensor) -> torch.Tensor:
        return tensorsketch_transform(params, X)

    def props(self, params: TensorSketchParams) -> EmbeddingProps:
        return EmbeddingProps(
            # degree 1 makes the sketch (affine-)linear in x, which commutes
            # with row means: the testable P4.1 statement.
            linear=params.kernel.degree == 1,
            discrepancy="l2",
            blockwise=False,
            landmark_free=self.landmark_free,
        )
