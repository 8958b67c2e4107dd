"""Arithmetic shared by the per-layer metrics' readers. Each reader returns
None where its run has nothing for it to read."""
from __future__ import annotations

from bench.kinds.fit import PHASE1


def _mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def phase1_s(run):
    """Phase 1's wall seconds a fit, from the estimator's ``phases_``."""
    if run.mix["kind"] != "fit":
        return None
    return _mean(sum(c.phases.get(p, 0.0) for p in PHASE1) for c in run.calls)


def lloyd_pass_s(run):
    """The Lloyd phase's wall seconds over its passes (iterations + 1)."""
    if run.mix["kind"] != "fit":
        return None
    return _mean(c.phases["lloyd"] / c.passes for c in run.calls)


def kernel_roofline_pct(run, kind: str):
    """The traced calls' counted work at the chip's peaks, over the device
    kernel time of the trace, in %."""
    if run.mix["kind"] != kind or not run.on_card or run.trace is None \
            or run.trace.kernel_s <= 0:
        return None
    precision = run.cfg["precision"]
    bound = sum(run.traffic.work(c).bound_s(precision) for c in run.traced)
    return 100.0 * bound / run.trace.kernel_s


def idle_pct(run, kind: str):
    """The share of the traced window with nothing running on the device, in %."""
    if run.mix["kind"] != kind or not run.on_card or run.trace is None \
            or run.trace.window_s <= 0:
        return None
    return 100.0 * (run.trace.window_s - run.trace.busy_s) / run.trace.window_s
