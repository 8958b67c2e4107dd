"""Traffic of batch predictions: ``KernelKMeans.predict`` back to back, one
caller, on batches already on the card. The calls cycle through a pool of
distinct batches drawn from the data's mixture, larger than the card's L2,
a share of whose rows lies between clusters.

The model is the benchmark's: the reference fits landmarks, gamma, R and the
centroids on a sample of the mixture, and the same float32 values go to the
program and, when its labels are judged, to the reference.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import work
from bench.reference import apnc, blobs, judge


@dataclasses.dataclass
class PredictCall:
    t0: float
    t1: float


class Traffic:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, policy):
        self.cfg, self.mix, self.seed, self.device, self.policy = cfg, mix, seed, device, policy
        self.answers: list = []  # (batch, labels) of the calls kept for the check
        self._rng = np.random.default_rng(blobs.stream_seed(seed, 6))

    def setup(self) -> None:
        from repro_torch.api import KernelKMeans
        from repro_torch.api.model import ClusterModel, FitMeta
        from repro_torch.core.apnc import APNCCoefficients
        from repro_torch.core.kernels_fn import Kernel

        cfg, mix, dev = self.cfg, self.mix, self.device
        mixture = blobs.mixture(cfg["d"], cfg["k"], cfg["separation"], self.seed, dev,
                                cfg["anisotropy"])
        sample, _ = blobs.rows(mixture, mix["model_sample_rows"], self.seed,
                               blobs.STREAM_MODEL, dev)
        L, R, gamma, C = apnc.fit_model(sample, cfg["k"], cfg["l"], cfg["m"],
                                        mix["model_steps"], blobs.stream_seed(self.seed, 5))
        L, R, C = (t.to(torch.float32).contiguous() for t in (L, R, C))
        self.model = (L, R, gamma, C)  # what both sides get, as float32 values
        del sample
        self.rows_per_call = mix["batch_rows"]
        self.batches, _ = blobs.rows(mixture, mix["pool_batches"] * self.rows_per_call,
                                     self.seed, blobs.STREAM_QUERIES, dev,
                                     between=mix["between_share"])
        params = APNCCoefficients(landmarks=L[None].clone(), R=R[None].clone(),
                                  kernel=Kernel("rbf", gamma=gamma), discrepancy="l2")
        self.est = KernelKMeans(cfg["k"], kernel="rbf", method=cfg["method"], l=cfg["l"],
                                m=cfg["m"], policy=self.policy, device=dev)
        self.est.model_ = ClusterModel(
            params=params, centroids=C.clone(), inertia=torch.zeros((), device=dev),
            meta=FitMeta(k=cfg["k"], method=cfg["method"], kernel_name="rbf", l=cfg["l"],
                         m=cfg["m"]))
        for b in range(mix["pool_batches"]):  # warm-up: every batch once
            self.est.predict(self._batch(b))

    def _batch(self, b: int) -> torch.Tensor:
        return self.batches[b * self.rows_per_call:(b + 1) * self.rows_per_call]

    def call(self, i: int) -> PredictCall:
        b = i % self.mix["pool_batches"]
        x = self._batch(b)
        t0 = time.perf_counter()
        labels = self.est.predict(x)
        t1 = time.perf_counter()
        # a uniform sample of the window's answers, drawn from the seed
        keep = self.mix["checked_calls"]
        if i < keep:
            self.answers.append((b, labels))
        else:
            j = int(self._rng.integers(0, i + 1))
            if j < keep:
                self.answers[j] = (b, labels)
        return PredictCall(t0, t1)

    def end_to_end(self, calls, window_s: float) -> dict:
        lat = np.array([c.t1 - c.t0 for c in calls])
        return {"predict_rows_per_s": self.rows_per_call * len(calls) / window_s,
                "predict_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def describe(self, calls) -> str:
        lat = np.array([c.t1 - c.t0 for c in calls]) * 1e3
        return (f"run: {len(calls)} calls, latency ms p50 {np.percentile(lat, 50):.4f} "
                f"p95 {np.percentile(lat, 95):.4f} max {lat.max():.4f}")

    def work(self, call: PredictCall) -> work.Work:
        return work.predict(self.cfg, self.rows_per_call)

    def release(self) -> None:
        self.est = None

    def check(self, calls, rng: np.random.Generator) -> dict:
        L, R, gamma, C = self.model
        return judge.judge_predict((L, R, gamma, C), self.batches, self.rows_per_call,
                                   self.answers)
