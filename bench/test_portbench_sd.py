"""The APNC-SD cell and the CovType fit cell on the CPU at a small size: the
port's SD fit against the float64 SD reference (`bench.reference.apnc_sd`),
the check's SD form, both cells' result lines, the planted faults, the
readers of the SD cell's metrics and the l1 work count."""
import json

import numpy as np
import pytest
import torch

from bench import work
from bench.harness import planted_sd
from bench.harness.runner import RunView, cell_spec, reader
from bench.harness.small import run_small
from bench.harness.trace import TraceSummary
from bench.reference import apnc, apnc_sd
from bench.work import l1
from repro_torch import obs
from repro_torch.api import KernelKMeans
from repro_torch.core.lloyd import lloyd
from repro_torch.data.synthetic import gaussian_blobs_blocks
from repro_torch.embed import apnc as port_apnc

SD_CELL = "imagenet-sd.fit-resident"
#: The small size's t: 40 % of its l = 48, as the paper's default.
SMALL_T = dict(t=19)
CELLS = [(SD_CELL, SMALL_T), ("covtype.fit-resident", {})]


def _data(n=1500, d=12, k=4):
    return torch.from_numpy(gaussian_blobs_blocks(3, n, d, k, block_rows=512,
                                                  separation=3.0)[0].materialize())


def test_the_host_s_is_the_per_row_write_bit_for_bit():
    # S was once written a row at a time where the landmarks live; built on
    # the host from the same draws it holds the same bits
    m, l, t = 40, 90, 36
    got = port_apnc._sd_directions(torch.Generator().manual_seed(11), m, l, t)
    gen, want = torch.Generator().manual_seed(11), torch.zeros((m, l))
    for r in range(m):
        want[r, torch.randperm(l, generator=gen)[:t]] = 1.0
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_reference_replays_the_fit_generator_s():
    X, l, m, t = _data(), 48, 24, 19
    gen = torch.Generator().manual_seed(5)
    port_apnc.sample_landmarks(gen, X, l)
    want = port_apnc._sd_directions(gen, m, l, t)
    assert torch.equal(apnc_sd.directions(X.shape[0], 5, l, m, t), want.double())


def _reference_phase1(X, l=48):
    gamma = apnc.self_tuned_gamma(X, 0)
    L = apnc.landmarks(X, 5, l)
    return gamma, L, apnc_sd.centered_gram(L, gamma)


def test_the_whitening_check_holds_for_any_sign_and_only_for_the_drawn_s():
    X, l, m, t = _data(), 48, 24, 19
    gamma, L, (G, H) = _reference_phase1(X, l)
    S = apnc_sd.directions(X.shape[0], 5, l, m, t)
    z = apnc_sd.unresolved(G)
    assert z == 1  # the constant vector, and nothing else at this size
    R = apnc_sd.sd_factor(G, H, S, t)
    assert apnc_sd.whiten_gap(R, G, S, t, z) < 1e-10
    # another whitening: every eigenvector's sign flipped at random
    lam, V = torch.linalg.eigh(G)
    flips = torch.from_numpy(np.random.default_rng(0).choice([-1.0, 1.0], l))
    keep = lam > apnc_sd.UNRESOLVED * float(lam[-1])
    E = (flips * torch.where(keep, lam.clamp(min=1e-300).rsqrt(), 0.0))[:, None] * V.T
    R_flipped = S @ E @ H / t ** 0.5
    assert (R_flipped - R).abs().max() > 0.1
    assert apnc_sd.whiten_gap(R_flipped, G, S, t, z) < 1e-10
    # S of another seed, or R left uncentered, reads wide
    other = apnc_sd.directions(X.shape[0], 6, l, m, t)
    assert apnc_sd.whiten_gap(apnc_sd.sd_factor(G, H, other, t), G, S, t, z) > 0.1
    assert apnc_sd.whiten_gap(R + 0.05, G, S, t, z) > 0.1


def test_the_port_s_sd_fit_against_the_reference():
    X, k = _data(), 4
    est = KernelKMeans(k, method="sd", backend="local", l=48, m=24, t=19, iters=6,
                       landmark_sample=1024, block_rows=512, random_state=9, device="cpu")
    est.fit(X)
    p = est.model_.params
    Lp, Rp, gamma = p.landmarks[0], p.R[0].double(), float(p.kernel.gamma)
    # phase 1: R is S E H / sqrt(t) for the replayed S and a whitening of G
    G, _ = apnc_sd.centered_gram(Lp, gamma)
    S = apnc_sd.directions(1024, apnc.phase1_seeds(9)[1], 48, 24, 19)
    assert apnc_sd.whiten_gap(Rp, G, S, 19, apnc_sd.unresolved(G)) < 1e-4
    # Lloyd under l1 from the same init: the same costs, step by step
    Y = apnc.embed(X, Lp, Rp, gamma)
    init = apnc_sd.kmeanspp(Y[:256], k, torch.Generator().manual_seed(1)).float()
    res = lloyd(Y.float(), k, discrepancy="l1", iters=4, init=init)
    costs, _, _ = apnc_sd.lloyd_steps(Y, init, len(res.costs))
    np.testing.assert_allclose(res.costs.double().numpy(), costs, rtol=1e-5)
    # the fit's answer: every label nearest under l1, the inertia their sum
    gap, cost = apnc_sd.label_gaps(Y, est.model_.centroids, torch.from_numpy(est.labels_))
    assert gap < 1e-4 and est.inertia_ == pytest.approx(cost, rel=1e-5)


def _contract(cell, result, lines):
    spec, _, _, _ = cell_spec(cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want == {"fit_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert lines[-1].startswith("check:") and lines[0].startswith("run:")


@pytest.mark.parametrize("cell, small", CELLS, ids=[c for c, _ in CELLS])
def test_a_new_cell_prints_the_contract_line_and_no_card_metric(cell, small):
    _contract(cell, *run_small(cell, seconds=0.5, **small))
    traced, _ = run_small(cell, trace=True, **small)
    assert "breakdown" not in traced and "busy_s" not in traced["device"]
    # off the card the SD cell's readers find nothing; the CovType fit reads
    # the estimator's phases, as the ImageNet fit does
    want = set() if cell == SD_CELL else {"phase1_s.fit", "lloyd_pass_s.fit"}
    assert set(traced["metrics"]) == want


@pytest.mark.parametrize("fault", sorted(planted_sd.FAULTS) + ["bf16", "frozen-after-3"])
def test_a_planted_sd_fault_is_not_correct(fault):
    policy, plant = planted_sd.reading(fault)
    with plant:
        result, lines = run_small(SD_CELL, policy=policy, **SMALL_T)
    assert result["correct"] is False, lines


# ------------------------------------------------------------ the readers

L1_NAME = "void (anonymous namespace)::assign_kernel<true, true>(float const*, float const*)"
L2_NAME = "void (anonymous namespace)::assign_kernel<false, true>(float const*, float const*)"


class _Call:
    def __init__(self, passes, l1_launches):
        self.passes, self.l1_launches = passes, l1_launches


def _view(calls, ops, kind="fit_sd", on_card=True):
    cfg = dict(n=1000, m=256, k=164, precision="f32")
    trace = TraceSummary(window_s=1.0, busy_s=0.5, kernel_s=sum(ops.values()), ops=ops, gaps=[])
    return RunView(cfg=cfg, mix={"kind": kind}, traffic=None, calls=calls, traced=calls,
                   trace=trace, on_card=on_card)


def test_the_l1_roofline_reads_the_l1_instantiation_alone():
    read = reader("l1_assign_roofline_pct.fit_sd")
    calls = [_Call(21, 21), _Call(5, 5)]
    bound = l1.assign(1000, 256, 164).bound_s("f32")
    view = _view(calls, {L1_NAME: 26 * bound * 4, L2_NAME: 1.0})
    assert read(view) == pytest.approx(25.0)
    assert read(_view([_Call(21, 0)], {L1_NAME: 1.0})) is None  # no counter: none counted
    assert read(_view([_Call(21, 20)], {L1_NAME: 1.0})) is None
    assert read(_view(calls, {L2_NAME: 1.0})) is None
    assert read(_view(calls, {L1_NAME: 1.0}, kind="fit")) is None
    assert read(_view(calls, {L1_NAME: 1.0}, on_card=False)) is None


def test_the_directions_reader_reads_the_span_mean():
    read = reader("sd_directions_ms.fit_sd")
    obs.reset_metrics("span.sd.")
    try:
        assert read(_view([], {})) is None
        for seconds in (2e-3, 4e-3):
            obs.histogram("span.sd.directions").observe(seconds)
        assert read(_view([], {})) == pytest.approx(3.0)
        assert read(_view([], {}, on_card=False)) is None
        assert read(_view([], {}, kind="fit")) is None
    finally:
        obs.reset_metrics("span.sd.")


def test_the_sd_idle_reader_reads_the_sd_window_alone():
    read = reader("idle_pct.fit_sd")
    assert read(_view([], {})) == pytest.approx(50.0)  # busy 0.5 s of a 1 s window
    assert read(_view([], {}, kind="fit")) is None
    assert read(_view([], {}, on_card=False)) is None


def test_the_l1_assignment_counts_twice_l2_at_the_imagenet_shape():
    n, m, k = 1_262_102, 256, 164
    assert l1.assign(n, m, k).bound_s("f32") * 1e3 == pytest.approx(3.16, abs=0.005)
    assert l1.assign(n, m, k).flops == 2 * work.assign(n, m, k).flops
    assert l1.assign(n, m, k).bytes == work.assign(n, m, k).bytes
    cfg = dict(n=n, d=900, l=500, m=m, k=k, seed_sample=1024)
    assert l1.fit(cfg, 21).flops == pytest.approx(
        work.fit(cfg, "local", 21).flops + 21 * work.assign(n, m, k).flops)
