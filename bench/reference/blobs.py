"""The benchmark's data: Gaussian blobs made on the device from the seed.

Adapted from the blob generator of the port's chip smoke script: one
``torch.Generator`` on the device, a few large calls, rows in chunks. Here
the mixture (centres and per-dimension scales) is drawn apart from the rows,
so that data sets drawn under other seed streams (a fit's X, a model's sample,
the batches that are predicted) come from one mixture.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Seed streams of one run, so that each data set is drawn independently.
STREAM_MIXTURE, STREAM_X, STREAM_MODEL, STREAM_QUERIES = 0, 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run's seed (any whole number)."""
    root = int(seed) % (1 << 64)
    state = np.random.SeedSequence(root, spawn_key=(int(stream),)).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class Mixture:
    centers: torch.Tensor  # (k, d)
    scales: torch.Tensor  # (k, d)


def mixture(d: int, k: int, separation: float, seed: int, device,
            anisotropy: float = 0.5) -> Mixture:
    """k Gaussian components in d dimensions: centres N(0, separation^2),
    per-dimension standard deviations in [1, 1 + anisotropy)."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, STREAM_MIXTURE))
    centers = torch.randn((k, d), generator=g, device=device) * separation
    scales = 1.0 + anisotropy * torch.rand((k, d), generator=g, device=device)
    return Mixture(centers, scales)


def rows(mix: Mixture, n: int, seed: int, stream: int, device, *, between: float = 0.0,
         chunk: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """n rows of the mixture and their components, drawn from one seed stream:
    (n, d) float32 and (n,) int64.

    A share ``between`` of the rows is drawn between two components a and b:
    around t c_a + (1 - t) c_b with t uniform in [0, 1) and the scales mixed
    alike, so that some rows lie on every boundary between clusters, as in
    data that is not made of clean clusters. Their component is a."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    k, d = mix.centers.shape
    labels = torch.randint(0, k, (n,), generator=g, device=device)
    X = torch.empty((n, d), device=device)
    for lo in range(0, n, chunk):
        lab = labels[lo:lo + chunk]
        center, scale = mix.centers[lab], mix.scales[lab]
        if between:
            rows_ = lab.shape[0]
            other = torch.randint(0, k, (rows_,), generator=g, device=device)
            t = torch.rand((rows_, 1), generator=g, device=device)
            mixed = torch.rand((rows_, 1), generator=g, device=device) < between
            t = torch.where(mixed, t, torch.ones_like(t))
            center = t * center + (1.0 - t) * mix.centers[other]
            scale = t * scale + (1.0 - t) * mix.scales[other]
        X[lo:lo + chunk] = center + torch.randn((lab.shape[0], d), generator=g,
                                                device=device) * scale
    return X, labels
