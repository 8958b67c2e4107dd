"""Small sizes of every cell, for the CPU tests: the same code paths at a
size a test run holds, on the program's plain route."""
from __future__ import annotations

import time

from bench.harness.runner import run_cell

#: Keys of the configurations and the mixes replaced in a small run.
SMALL = dict(n=3000, d=16, k=5, l=48, m=24, block_rows=512, landmark_sample=1024,
             seed_sample=256, batch_rows=1024, pool_batches=4, model_sample_rows=2048,
             traced_calls=1, checked_calls=8)
CELLS = ("imagenet.predict-batch", "imagenet.fit-resident", "covtype.predict-batch")
#: A seed past 32 signed bits, as a run's may be.
SEED = 2**31 + 977


def run_small(cell: str, *, seconds: float = 0.2, trace: bool = False, seed: int = SEED,
              policy=None, **overrides):
    """``run_cell`` on the CPU at the small sizes; returns (result, lines)."""
    return run_cell(cell, seed, seconds, trace, device="cpu", t_start=time.perf_counter(),
                    policy=policy, overrides={**SMALL, **overrides})
