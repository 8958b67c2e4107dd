"""The least work each layer of a cell needs, from the configuration's shapes,
and the chip's peaks to hold it against.

Counts are of the algorithm, not of any kernel: the embed of R rows is
2 R d l flops for kappa(X, L) and 2 R l m for the product with R^T; the
assignment is 2 R m k for the distances to k centroids. Bytes count each
input read once and each output written once (float32 values, int32
labels). A kernel that reads a tile twice, or a path that writes Y and reads
it back, does more than this; the count does not grow with it.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

F32 = 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, times: float) -> "Work":
        return Work(self.flops * times, self.bytes * times)

    __rmul__ = __mul__

    def bound_s(self, precision: str = "f32") -> float:
        """The least time the chip takes: the larger of the flops over the
        compute peak of ``precision`` and the bytes over the memory peak."""
        return max(self.flops / PEAKS["flops_per_s"][precision],
                   self.bytes / PEAKS["bytes_per_s"])


def embed(R: int, d: int, l: int, m: int) -> Work:
    """Y = kappa(X, L) R^T for R rows: X, L and R in, Y out."""
    return Work(2.0 * R * d * l + 2.0 * R * l * m, F32 * (R * d + l * d + m * l + R * m))


def assign(R: int, m: int, k: int) -> Work:
    """Nearest centroid and the (Z, g) sums of R embedded rows: Y and C in,
    labels and Z, g out."""
    return Work(2.0 * R * m * k, F32 * (R * m + k * m + R + k * m + k))


def fused_step(R: int, d: int, l: int, m: int, k: int) -> Work:
    """Embed and assign without Y in memory: X, L, R and C in, labels and
    Z, g out."""
    return Work(2.0 * R * d * l + 2.0 * R * l * m + 2.0 * R * m * k,
                F32 * (R * d + l * d + m * l + k * m + R + k * m + k))


def fit(cfg: dict, backend: str, passes: int) -> Work:
    """One fit's Lloyd work over n rows, ``passes`` = iterations + the final
    assignment, plus the embed of the k-means++ seeding pool. ``local`` embeds
    X once and assigns each pass; ``stream`` embeds every block again in
    each pass, as data that the card does not hold must be."""
    n, d, l, m, k = (cfg[key] for key in ("n", "d", "l", "m", "k"))
    pool = embed(cfg["seed_sample"], d, l, m)
    if backend == "stream":
        return pool + passes * fused_step(n, d, l, m, k)
    return pool + embed(n, d, l, m) + passes * assign(n, m, k)


def predict(cfg: dict, rows: int) -> Work:
    """Labels of ``rows`` rows: the embed and the nearest centroid."""
    d, l, m, k = (cfg[key] for key in ("d", "l", "m", "k"))
    return embed(rows, d, l, m) + Work(2.0 * rows * m * k, F32 * (rows * m + k * m + rows))
