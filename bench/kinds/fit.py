"""Traffic of whole fits: ``KernelKMeans.fit`` back to back, one caller.

The mix names the backend and where X is held (``x_on``). ``"card"``: X is
made whole on the card, as a caller holding a CUDA tensor has it, and phase
1 copies it to the host. ``"host"``: X is made on the card, moved to pinned
host memory and handed to the fit as a ``BlockStore`` of ``block_rows``-row
blocks, as data that the card does not hold is (the stream backend reads
every block again in each pass). Fit i of a run draws its ``random_state``
from the run's seed and i, so the seeds of a run vary the draws and never
the sizes.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import work
from bench.reference import blobs, judge

#: Phases of the estimator that make up phase 1.
PHASE1 = ("host_view", "reservoir", "embed_fit", "seed")


@dataclasses.dataclass
class FitCall:
    t0: float
    t1: float
    phases: dict
    n_iter: int
    output: judge.FitOutput

    @property
    def passes(self) -> int:
        return self.n_iter + 1


def random_state(seed: int, i: int) -> int:
    """The ``random_state`` of fit i of a run (i = -1: the warm-up fit)."""
    return blobs.stream_seed(seed, 100 + i) % (1 << 31)


class Traffic:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, policy):
        self.cfg, self.mix, self.seed, self.device, self.policy = cfg, mix, seed, device, policy

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        mix = blobs.mixture(cfg["d"], cfg["k"], cfg["separation"], self.seed, dev,
                            cfg["anisotropy"])
        self.X, _ = blobs.rows(mix, cfg["n"], self.seed, blobs.STREAM_X, dev)
        self.data = self.X
        if self.mix["x_on"] == "host":
            from repro_torch.stream.blockstore import BlockStore

            pinned = torch.empty(self.X.shape, dtype=self.X.dtype,
                                 pin_memory=dev.type == "cuda")
            self.X = pinned.copy_(self.X)
            self.data = BlockStore.from_array(self.X.numpy(), cfg["block_rows"])
        # The warm-up: a fit of one Lloyd iteration runs every kernel at every
        # shape of the window's fits (phase 1, a step pass, the final pass).
        self.call(-1, iters=1)

    def _estimator(self, rs: int, iters: int):
        from repro_torch.api import KernelKMeans

        c = self.cfg
        return KernelKMeans(
            c["k"], kernel=c["kernel"], method=c["method"], backend=self.mix["backend"],
            l=c["l"], m=c["m"], iters=iters, n_init=1, block_rows=c["block_rows"],
            landmark_sample=c["landmark_sample"], seed_sample=c["seed_sample"],
            policy=self.policy, random_state=rs, device=self.device)

    def call(self, i: int, iters: int | None = None) -> FitCall:
        rs = random_state(self.seed, i)
        est = self._estimator(rs, self.cfg["iters"] if iters is None else iters)
        t0 = time.perf_counter()
        est.fit(self.data)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        p, model = est.model_.params, est.model_
        rep = est.fit_report_
        out = judge.FitOutput(
            random_state=rs, landmarks=p.landmarks[0], R=p.R[0], gamma=float(p.kernel.gamma),
            centroids=model.centroids, labels=est.labels_, inertia=float(est.inertia_),
            trajectory=list(rep.inertia_trajectory), shifts=list(rep.centroid_shifts),
            n_iter=int(est.n_iter_))
        return FitCall(t0, t1, dict(est.phases_), int(est.n_iter_), out)

    def end_to_end(self, calls, window_s: float) -> dict:
        return {"fit_s": window_s / len(calls)}

    def describe(self, calls) -> str:
        return (f"run: {len(calls)} fits, iterations {[c.n_iter for c in calls]}, "
                f"seconds {[round(c.t1 - c.t0, 4) for c in calls]}")

    def work(self, call: FitCall) -> work.Work:
        return work.fit(self.cfg, self.mix["backend"], call.passes)

    def release(self) -> None:
        """Nothing of the program outlives a call: each fit's estimator is
        dropped when the call returns, and its outputs are plain tensors."""

    def check(self, calls, rng: np.random.Generator) -> dict:
        """The judge's numbers, each the worst over a sample of the window's
        fits drawn from the seed."""
        picks = rng.choice(len(calls), size=min(self.mix["checked_fits"], len(calls)),
                           replace=False)
        X_host = self.X.cpu().numpy()
        worst: dict = {}
        for i in sorted(int(p) for p in picks):
            got = judge.judge_fit(self.X, X_host, self.cfg, calls[i].output, self.device)
            for name, value in got.items():
                worst[name] = max(worst.get(name, value), value)
        return worst
