"""The least work of the l1 assignment (APNC-SD's discrepancy), held to the
chip's float32 peak.

An l1 element, ``acc += |y - c|``, is two float32 instructions, a subtract
and an add that takes the absolute value as an operand modifier, and
neither is a fused multiply-add; l2's expanded form needs one FMA an
element. The chip's float32 peak (``peaks.json``) counts an FMA as two
operations, so it issues half as many instructions a second: one l1
element costs what two FMAs cost, and R rows against k centroids of width
m count 2 R m k instructions, 4 R m k at that peak. Bytes are those of
``bench.work.assign``: Y and C in, labels and the (Z, g) sums out.
"""
from __future__ import annotations

from bench import work


def assign(R: int, m: int, k: int) -> work.Work:
    """Nearest centroid under l1 and the (Z, g) sums of R embedded rows."""
    return work.Work(4.0 * R * m * k, work.assign(R, m, k).bytes)


def fit(cfg: dict, passes: int) -> work.Work:
    """``bench.work.fit`` of a local fit with the assignment under l1: the
    pool's and X's embeds and ``passes`` l1 assignments of n rows."""
    n, d, l, m, k = (cfg[key] for key in ("n", "d", "l", "m", "k"))
    return (work.embed(cfg["seed_sample"], d, l, m) + work.embed(n, d, l, m)
            + passes * assign(n, m, k))
