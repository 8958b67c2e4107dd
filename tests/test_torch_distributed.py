"""The port's `core.distributed` (Algorithms 1 + 2 over the row shards of a
resident X) and the ``shard_map`` backend against the JAX package's, on the
CPU.

The four clustering cases of tests/test_distributed_subprocess.py are
ported over a host mesh of ``cpu`` entries in process. The JAX package
checks its two communication claims on the lowered HLO; the port has no HLO
and counts its reductions (``reduce.cross_device``): none in an embedding,
one a Lloyd iteration. `distributed_lloyd(return_costs=True)` is held
against the JAX package's on a one-device mesh in process: labels equal,
centroids and costs within rtol 1e-5 (the shards group the float sums
differently).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import distributed_lloyd as j_distributed_lloyd
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.policy import ComputePolicy as JPolicy
from repro_torch import obs
from repro_torch.api import KernelKMeans
from repro_torch.core import distributed as tdist
from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
from repro_torch.core.kkmeans import APNCConfig, fit_coefficients, fit_predict
from repro_torch.core.metrics import nmi
from repro_torch.data.curation import cluster_corpus
from repro_torch.data.synthetic import gaussian_blobs
from repro_torch.launch.mesh import make_host_mesh


def reductions() -> int:
    """The ``reduce.cross_device`` count: one a cross-device sum of D > 1."""
    return int(obs.counter("reduce.cross_device").value)


def _check_apnc_distributed_equals_single(results):
    mesh = make_host_mesh(data=4, model=2)
    X, y = gaussian_blobs(0, 1024, 12, 5, separation=4.0, device="cpu")
    kern = self_tuned_rbf(X)
    cfg = APNCConfig(method="nystrom", l=128, m=64)
    res, coeffs = fit_predict(1, X, kern, 5, cfg, device="cpu")
    labels_d, _, coeffs_d = tdist.distributed_fit_predict(mesh, 1, X, kern, 5, cfg)
    truth = y.numpy()
    results["apnc_dist_nmi_vs_truth"] = nmi(labels_d.numpy(), truth)
    results["apnc_single_nmi_vs_truth"] = nmi(res.labels.numpy(), truth)
    results["apnc_dist_vs_single_nmi"] = nmi(labels_d.numpy(), res.labels.numpy())
    results["apnc_coeff_max_diff"] = float((coeffs.R - coeffs_d.R).abs().max())


def _check_embedding_is_collective_free(results):
    mesh = make_host_mesh(data=4, model=2)
    X, _ = gaussian_blobs(2, 512, 8, 3, device="cpu")
    coeffs = fit_coefficients(3, X, self_tuned_rbf(X), APNCConfig(l=64, m=32))
    before = reductions()
    Y = tdist.distributed_embed(mesh, X, coeffs)
    results["embed_reductions"] = reductions() - before
    results["embed_shards"] = len(Y)


def _check_lloyd_comm_is_zg_only(results):
    """The paper's claim: an iteration moves only (Z, g), k * m + k floats a
    shard, whatever n: one reduction an iteration, of exactly that payload."""
    mesh = make_host_mesh(data=8, model=1)
    k, m, iters = 5, 32, 7
    Y = torch.randn((2048, m), generator=torch.Generator().manual_seed(4))
    moved = []
    real = tdist.cross_device_sum

    def counting(accs, devices):
        moved.append(sum(t.numel() for acc in accs[1:] for t in acc))
        return real(accs, devices)

    tdist.cross_device_sum = counting
    try:
        before = reductions()
        tdist.distributed_lloyd(mesh, Y, Y[:k], k=k, discrepancy="l2", iters=iters)
        results["lloyd_reductions"] = reductions() - before
    finally:
        tdist.cross_device_sum = real
    expected = iters * (8 - 1) * (k * m + k)  # floats sent into the reducer
    results["lloyd_moved_floats"] = sum(moved)
    results["lloyd_comm_ratio"] = sum(moved) / expected


@pytest.fixture(scope="module")
def report():
    results: dict = {}
    for check in (_check_apnc_distributed_equals_single, _check_embedding_is_collective_free,
                  _check_lloyd_comm_is_zg_only):
        try:
            check(results)
        except Exception as e:  # noqa: BLE001 - each failure becomes an ERROR_ key
            results[f"ERROR_{check.__name__}"] = f"{type(e).__name__}: {e}"
    return results


def test_no_errors(report):
    errs = {k: v for k, v in report.items() if k.startswith("ERROR_")}
    assert not errs, errs


def test_apnc_distributed_equals_single(report):
    # the same seed split gives the same coefficients; the Lloyd runs may land
    # in other local optima (a sampled seeding pool), hence the NMI gates
    assert report["apnc_coeff_max_diff"] < 1e-5
    assert report["apnc_dist_nmi_vs_truth"] > 0.8
    assert report["apnc_dist_vs_single_nmi"] > 0.8


def test_embedding_collective_free(report):
    assert report["embed_reductions"] == 0 and report["embed_shards"] == 4


def test_lloyd_moves_only_Z_and_g(report):
    assert report["lloyd_reductions"] == 7
    assert report["lloyd_comm_ratio"] == 1.0, report


# ------------------------------------------------ against the JAX package


@pytest.fixture(scope="module")
def blob_y():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((4, 10)) * 3.0
    lab = rng.integers(0, 4, 960)
    Y = (centers[lab] + rng.standard_normal((960, 10))).astype(np.float32)
    return Y, Y[rng.choice(960, 4, replace=False)].copy()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_distributed_lloyd_matches_the_reference(blob_y, disc, shards):
    """The port's `distributed_lloyd(return_costs=True)` on 1 and 4 shards
    against the JAX package's on its one-device mesh: labels equal;
    centroids and per-iteration costs within rtol 1e-5 (atol 1e-5 on the
    centroids)."""
    Y, c0 = blob_y
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    jl, jc, jcosts = j_distributed_lloyd(jmesh, jnp.asarray(Y), jnp.asarray(c0), k=4,
                                         discrepancy=disc, iters=6,
                                         policy=JPolicy(pallas=False), return_costs=True)
    before = reductions()
    tl, tc, tcosts = tdist.distributed_lloyd(
        make_host_mesh(data=shards, model=1), torch.from_numpy(Y), torch.from_numpy(c0), k=4,
        discrepancy=disc, iters=6, return_costs=True)
    # one reduction an iteration and one for the costs; none on one shard
    assert reductions() - before == (7 if shards > 1 else 0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), rtol=1e-5)
    tl2, tc2 = tdist.distributed_lloyd(make_host_mesh(data=shards, model=1),
                                       torch.from_numpy(Y), torch.from_numpy(c0), k=4,
                                       discrepancy=disc, iters=6)
    assert torch.equal(tl2, tl) and torch.equal(tc2, tc)


def test_shard_rows_and_global_sample():
    mesh = make_host_mesh(data=4, model=2)
    X = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    shards = tdist.shard_rows(mesh, X)
    assert [s.shape[0] for s in shards] == [5] * 4 and tdist.data_axes_of(mesh) == ("data",)
    assert torch.equal(torch.cat(shards), X)
    got = tdist.sample_rows_global(torch.Generator().manual_seed(3), shards, 7)
    want = X[torch.randperm(20, generator=torch.Generator().manual_seed(3))[:7]]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        tdist.shard_rows(mesh, X[:19])


def test_shard_map_backend_reaches_the_local_labels():
    """``backend="shard_map"`` over four shards, through the public API: the
    labels of the local backend from the same seed, once both sit at the
    fixed point (rtol 1e-4 on the inertia); n that does not divide the mesh
    raises before any Lloyd work."""
    X, _ = gaussian_blobs(3, 800, 6, 4, separation=4.0, device="cpu")
    common = dict(kernel=Kernel("rbf", gamma=0.1), l=48, m=24, iters=15, n_init=2)
    local = KernelKMeans(4, backend="local", device="cpu", **common).fit(X.numpy(), seed=5)
    est = KernelKMeans(4, backend="shard_map", mesh=make_host_mesh(data=4, model=1),
                       **common).fit(X.numpy(), seed=5)
    assert est.backend_ == "shard_map" and est.n_iter_ == 15
    np.testing.assert_array_equal(est.labels_, local.labels_)
    assert est.inertia_ == pytest.approx(local.inertia_, rel=1e-4)
    assert est.fit_report_.inertia_trajectory[-1] == est.inertia_
    with pytest.raises(ValueError, match="divisible"):
        KernelKMeans(4, backend="shard_map", mesh=make_host_mesh(data=3, model=1),
                     **common).fit(X.numpy()[:800 - 1], seed=5)


def test_cluster_corpus_through_shard_map():
    X, y = gaussian_blobs(4, 600, 8, 3, separation=5.0, device="cpu")
    labels, centroids, params = cluster_corpus(make_host_mesh(data=4, model=2), X.numpy(), 3,
                                               method="sd", l=48, m=24, seed=1)
    assert labels.shape == (600,) and labels.dtype == np.int32
    assert centroids.shape == (3, 24) and params.discrepancy == "l1"
    assert nmi(labels, y.numpy()) > 0.9
    assert dataclasses.is_dataclass(params)

