"""The check fails a run whose timed path is broken underneath, once for each
fault the cell can have, and fails the program's lower-precision route."""
import time

import numpy as np
import pytest
import torch

from bench.harness import planted
from bench.harness.small import run_small
from repro_torch.core import kkmeans
from repro_torch.kernels import ops

FIT_CELLS = ("imagenet.fit-resident",)
PREDICT_CELLS = ("imagenet.predict-batch", "covtype.predict-batch")


def _half_stats(step):
    """The step's (Z, g) from the first half of the block only."""
    def wrapped(self, block, centroids):
        Z, g, labels, cost = step(self, block, centroids)
        half = block.shape[0] // 2
        Zh, gh, _, _ = step(self, block[:half], centroids)
        return Zh, gh, labels, cost
    return wrapped


def _altered_assign(assign):
    def wrapped(self, block, centroids):
        labels, cost = assign(self, block, centroids)
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % centroids.shape[0]
        return labels, cost
    return wrapped


def _fault(monkeypatch, fault):
    if fault == "half the batch":
        monkeypatch.setattr(ops.LloydStepPlan, "step", _half_stats(ops.LloydStepPlan.step))
    elif fault == "answer altered":
        monkeypatch.setattr(ops.LloydStepPlan, "assign",
                            _altered_assign(ops.LloydStepPlan.assign))


@pytest.mark.parametrize("cell", FIT_CELLS)
@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "answer altered"])
def test_a_broken_fit_is_not_correct(monkeypatch, cell, fault):
    _fault(monkeypatch, fault)
    _, plant = planted.reading("state-unchanged" if fault == "state unchanged" else "program")
    with plant:
        result, _ = run_small(cell)
    assert result["correct"] is False


def _altered_labels(Y, centroids, discrepancy, policy=None):
    labels = kkmeans_assign(Y, centroids, discrepancy, policy).clone()
    labels[0] = (labels[0] + 1) % centroids.shape[0]
    return labels


kkmeans_assign = ops.assign_labels


def _half_predict(X, coeffs, centroids, *, policy=None, device=None):
    half = X.shape[0] // 2
    labels = kkmeans_predict(X[:half], coeffs, centroids, policy=policy, device=device)
    return torch.cat([labels, labels[:X.shape[0] - half]])


kkmeans_predict = kkmeans.predict


@pytest.mark.parametrize("cell", PREDICT_CELLS)
@pytest.mark.parametrize("fault", ["half the batch", "answer altered"])
def test_a_broken_predict_is_not_correct(monkeypatch, cell, fault):
    if fault == "answer altered":
        monkeypatch.setattr(ops, "assign_labels", _altered_labels)
    else:
        monkeypatch.setattr(kkmeans, "predict", _half_predict)
    result, _ = run_small(cell)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", FIT_CELLS + PREDICT_CELLS)
def test_the_bf16_route_is_not_correct(cell):
    policy, _ = planted.reading("bf16")
    result, lines = run_small(cell, policy=policy)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", FIT_CELLS)
@pytest.mark.parametrize("fault", ["gram-bf16", "gamma-bf16", "frozen-after-3"])
def test_a_planted_fault_of_the_controls_helper_is_not_correct(cell, fault):
    # phase 1 off the reference's gram or gamma, and a fit whose centroid
    # updates stop after the three steps that the reference follows
    policy, plant = planted.reading(fault)
    with plant:
        result, lines = run_small(cell, policy=policy)
    assert result["correct"] is False, lines


@pytest.mark.gpu
@pytest.mark.parametrize("cell", FIT_CELLS + PREDICT_CELLS)
def test_the_tf32_route_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from bench.harness.runner import run_cell
    from bench.harness.small import SEED, SMALL

    policy, plant = planted.reading("tf32")
    with plant:
        result, lines = run_cell(cell, SEED, 0.2, False, device="cuda", t_start=time.perf_counter(),
                                 policy=policy,
                                 overrides=dict(SMALL, d=900, l=500, m=256, k=164,
                                                n=65536, batch_rows=65536))
    assert result["correct"] is False, lines
    assert np.isfinite([c["value"] for c in result["checks"].values()
                        if c["value"] is not None]).all()
