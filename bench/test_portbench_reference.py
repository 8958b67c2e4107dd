"""The benchmark's float64 reference against the program's CPU plain route at
a small size: the same draws from the same seeds, and the same maths."""
import numpy as np
import pytest
import torch

from bench.reference import apnc, blobs
from repro_torch.api.estimator import phase1_seeds, restart_generator
from repro_torch.core.kernels_fn import self_tuned_rbf
from repro_torch.core.lloyd import kmeanspp_init, lloyd
from repro_torch.embed import transform
from repro_torch.embed.apnc import fit_nystrom
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.reservoir import reservoir_sample

SEED = 2**31 + 41


@pytest.fixture(scope="module")
def data():
    mix = blobs.mixture(12, 4, 1.5, SEED, "cpu")
    X, _ = blobs.rows(mix, 1500, SEED, blobs.STREAM_X, "cpu")
    return X


def test_seeds_and_draws_follow_the_program(data):
    assert apnc.phase1_seeds(SEED) == phase1_seeds(SEED)
    g_ref, g_prog = apnc.restart_generator(7, 0), restart_generator(7, 0)
    assert torch.equal(torch.randperm(50, generator=g_ref), torch.randperm(50, generator=g_prog))
    X = data.numpy()
    blocks = (X[lo:lo + 128] for lo in range(0, len(X), 128))
    ref = apnc.reservoir_sample(blocks, len(X), X.shape[1], 400, 5)
    assert np.array_equal(ref, reservoir_sample(BlockStore.from_array(X, 128), 400, seed=5))
    sample = torch.from_numpy(ref)
    assert apnc.self_tuned_gamma(sample, 9) == pytest.approx(
        self_tuned_rbf(sample, seed=9).gamma, rel=1e-6)
    kern = self_tuned_rbf(sample, seed=9)
    params = fit_nystrom(11, sample, kern, l=40, m=16)
    assert torch.equal(apnc.landmarks(sample, 11, 40), params.landmarks[0])


def test_embedding_seeding_and_lloyd_match_the_plain_route(data):
    kern = self_tuned_rbf(data, seed=3)
    params = fit_nystrom(4, data, kern, l=40, m=16)
    L, R = params.landmarks[0], params.R[0]
    Y = apnc.embed(data, L, R, kern.gamma)
    Yp = transform(params, data)
    assert torch.allclose(Yp.double(), Y, atol=1e-6 * float(Y.abs().max()))
    # the reference's R whitens the gram it was fitted on
    Rr, top = apnc.nystrom(L, kern.gamma, 16)
    K = apnc.rbf(L, L, kern.gamma)
    assert torch.allclose(Rr @ K @ Rr.T, torch.eye(16, dtype=torch.float64), atol=1e-8)
    assert float((Rr @ K).square().sum()) == pytest.approx(float(top.sum()), rel=1e-10)

    C0 = apnc.kmeanspp(Y[:300], 4, restart_generator(8, 0))
    C0p = kmeanspp_init(restart_generator(8, 0), Yp[:300], 4, "l2")
    assert torch.allclose(C0p.double(), C0, atol=1e-6)
    costs, shifts, _ = apnc.lloyd_steps(Y, C0, 3)
    res = lloyd(Yp, 4, discrepancy="l2", iters=3, init=C0p)
    assert res.costs.tolist() == pytest.approx(costs, rel=1e-5)
    assert res.shifts.tolist() == pytest.approx(shifts, rel=1e-4)
    gap, cost = apnc.label_gaps(Y, res.centroids, res.labels)
    assert gap <= 1e-6 and cost == pytest.approx(float(res.inertia), rel=1e-5)


def test_a_wrong_label_reads_its_gap(data):
    Y = torch.randn(200, 8, dtype=torch.float64)
    C = Y[:3].clone()
    labels, near = apnc.assign(Y, C)
    assert apnc.label_gaps(Y, C, labels)[0] == 0.0
    bad = labels.clone()
    bad[5] = (bad[5] + 1) % 3
    assert apnc.label_gaps(Y, C, bad)[0] > 0.0
    bad[5] = 7
    assert apnc.label_gaps(Y, C, bad)[0] == float("inf")




def test_the_update_gap_reads_a_fit_that_stopped_updating(data):
    kern = self_tuned_rbf(data, seed=3)
    params = fit_nystrom(4, data, kern, l=40, m=16)
    Y = apnc.embed(data, params.landmarks[0], params.R[0], kern.gamma)
    C0 = apnc.kmeanspp(Y[:300], 4, restart_generator(8, 0))
    _, shifts, C = apnc.lloyd_steps(Y, C0, 2)
    assert shifts[-1] > 0
    # sound after any number of steps, converged or not, given the last shift
    assert apnc.update_gap(Y, C, shifts[-1]) < 1e-12
    _, shifts, C = apnc.lloyd_steps(Y, C0, 30)
    assert apnc.update_gap(Y, C, shifts[-1]) < 1e-12
    # the seeding itself, reported as an update of norm 0
    assert apnc.update_gap(Y, C0, 0.0) > 1e-3
