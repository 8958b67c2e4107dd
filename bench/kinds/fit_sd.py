"""Traffic of whole APNC-SD fits (Algorithm 4, e = l1): the fit kind's loop,
data, seeds and outputs, with the configuration's t, judged against the SD
reference (``bench/reference/judge_sd.py``) and counted with the l1
assignment's work (``bench/work/l1.py``). Each call also records the l1
assign launches its fit made, from the program's ``launch.apnc_assign.l1``
counter (0 where the program keeps none).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.kinds import fit
from bench.reference import judge_sd
from bench.work import Work, l1

COUNTER = "launch.apnc_assign.l1"


@dataclasses.dataclass
class SDFitCall(fit.FitCall):
    l1_launches: int = 0


def _l1_launches() -> int:
    from repro_torch import obs

    return int(obs.snapshot(COUNTER).get(COUNTER, 0))


class Traffic(fit.Traffic):
    def _estimator(self, rs: int, iters: int):
        est = super()._estimator(rs, iters)
        est.t = self.cfg["t"]
        return est

    def call(self, i: int, iters: int | None = None) -> SDFitCall:
        before = _l1_launches()
        rec = super().call(i, iters)
        fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}
        return SDFitCall(**fields, l1_launches=_l1_launches() - before)

    def work(self, call) -> Work:
        return l1.fit(self.cfg, call.passes)

    def check(self, calls, rng: np.random.Generator) -> dict:
        """The SD judge's numbers, each the worst over a sample of the
        window's fits drawn from the seed."""
        picks = rng.choice(len(calls), size=min(self.mix["checked_fits"], len(calls)),
                           replace=False)
        X_host = self.X.cpu().numpy()
        worst: dict = {}
        for i in sorted(int(p) for p in picks):
            got = judge_sd.judge_fit(self.X, X_host, self.cfg, calls[i].output, self.device)
            for name, value in got.items():
                worst[name] = max(worst.get(name, value), value)
        return worst
