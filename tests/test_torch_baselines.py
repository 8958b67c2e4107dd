"""The paper's baselines, the legacy drivers and the synthetic data of the
port against the JAX package's.

Each baseline's arithmetic (`_exact_lloyd`, `_approx_lloyd`, `_vector_lloyd`,
`_propagate`) runs on the JAX package's own draws (its `jax.random` labels0,
landmarks, row choices and RFF W) and must give its labels, outside near
ties, and its objective within rtol 1e-5. The ports of tests/test_kkmeans.py
draw from the port's own generators, so they are held by NMI as the JAX
tests are. `fit_predict`, `predict` and `stream_fit_predict` are held
against the JAX package's from the same params and init.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import kkmeans as jkk
from repro.core.kernels_fn import self_tuned_rbf as j_self_tuned_rbf
from repro.core.lloyd import kmeanspp_init as j_kmeanspp
from repro.core.nystrom import sample_landmarks as j_sample_landmarks
from repro.data import synthetic as jsyn
from repro.embed.rff import RFFEmbedding as JRFFEmbedding
from repro.stream.blockstore import BlockStore as JBlockStore
from repro.stream.lloyd import stream_fit_predict as j_stream_fit_predict
from repro.stream.reservoir import reservoir_sample as j_reservoir
from repro_torch.convert import apnc_params_from_numpy, rff_params_from_numpy
from repro_torch.core import baselines as tb
from repro_torch.core import kkmeans as tkk
from repro_torch.core import nystrom as tnys
from repro_torch.core import stable as tstable
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.metrics import nmi
from repro_torch.data import synthetic as tsyn
from repro_torch.embed.rff import rff_transform
from repro_torch.stream import lloyd as tlloyd
from repro_torch.stream.blockstore import BlockStore

K = 5


@pytest.fixture(scope="module")
def blobs():
    """tests/test_kkmeans.py's fixture: 800 x 12, 5 clusters, self-tuned rbf."""
    X, y = jsyn.gaussian_blobs(jax.random.PRNGKey(0), 800, 12, 5, separation=4.0)
    jkern = j_self_tuned_rbf(X)
    return X, np.asarray(y), jkern, Kernel("rbf", gamma=float(jkern.gamma))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _near_ties_only(d2: torch.Tensor, got: torch.Tensor, want, rtol=1e-4):
    """Labels equal outside near ties: every row where ``got`` and ``want``
    differ has its two clusters within rtol * max|d2 row| of each other
    under ``d2`` (the port's final distances)."""
    want = torch.from_numpy(np.array(want)).long()
    got = got.long()
    rows = torch.nonzero(got != want).flatten()
    assert rows.numel() <= 0.01 * got.shape[0], rows.numel()
    if rows.numel():
        gap = (d2[rows, got[rows]] - d2[rows, want[rows]]).abs()
        scale = d2[rows].abs().max(dim=1).values
        assert bool((gap <= rtol * scale).all()), (gap / scale).max()


def _check(res, want, d2):
    assert res.labels.dtype == torch.int32
    _near_ties_only(d2, res.labels, want.labels)
    np.testing.assert_allclose(float(res.objective), float(want.objective), rtol=1e-5)


# ------------------------------------------- the arithmetic, from JAX's draws


def test_exact_lloyd_from_jax_draws(blobs):
    X, _, jkern, _ = blobs
    key = jax.random.PRNGKey(5)
    Kj, diag = jkern.gram(X, X), jkern.diag(X)
    want = jb.exact_kernel_kmeans(key, Kj, diag, K)
    labels0 = _t(jax.random.randint(key, (X.shape[0],), 0, K))
    Kt, dt = _t(Kj), _t(diag)
    got, d2 = tb._exact_lloyd(Kt, dt, labels0, K, 20)
    _check(got, want, d2)


def test_approx_lloyd_from_jax_draws(blobs):
    X, _, jkern, kern = blobs
    k_s, k_i = jax.random.split(jax.random.PRNGKey(5))
    want = jb.approx_kkm(jax.random.PRNGKey(5), X, jkern, K, l=128)
    L = _t(j_sample_landmarks(k_s, X, 128))
    Xt = _t(X)
    A = kern.gram(L, L)
    A_inv = tb._pinv(A + 1e-6 * torch.eye(128))
    D = kern.gram(Xt, L)
    labels0 = _t(jax.random.randint(k_i, (X.shape[0],), 0, K))
    got, d2 = tb._approx_lloyd(D, A, A_inv, kern.diag(Xt), labels0, K, 20)
    _check(got, want, d2)


def test_pinv_cutoff_is_the_references():
    """A singular value between torch's default cutoff (max(rows, cols) *
    eps) and the JAX package's (ten times that) is dropped, as jnp drops it."""
    l = 64
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((l, l)))
    s = np.ones(l)
    s[-1] = 3 * l * np.finfo(np.float32).eps  # kept by torch's default, not by jnp
    A = (Q * s) @ Q.T
    A = ((A + A.T) / 2).astype(np.float32)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(A)))
    got = tb._pinv(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    default = torch.linalg.pinv(torch.from_numpy(A)).numpy()
    assert np.abs(default - want).max() > 100  # the default keeps 1 / s[-1]


def _jax_rff(X, gamma, m, key):
    """The port's features over the JAX package's W for ``key``'s feature
    half, and the key's clustering half."""
    from repro.core.kernels_fn import Kernel as JKernel

    k_f, k_c = jax.random.split(key)
    W = np.asarray(JRFFEmbedding().fit(k_f, X, JKernel("rbf", gamma=float(gamma)), l=0, m=m).W)
    params = rff_params_from_numpy(W, {"name": "rbf", "gamma": float(gamma)}, device="cpu")
    return rff_transform(params, _t(X)), k_c


def test_rff_features_equal_the_references(blobs):
    X, _, jkern, _ = blobs
    Z, _ = _jax_rff(X, jkern.gamma, 256, jax.random.PRNGKey(5))
    k_f, _ = jax.random.split(jax.random.PRNGKey(5))
    want = np.asarray(jb.rff_features(k_f, X, jkern.gamma, 256))
    np.testing.assert_allclose(Z.numpy(), want, rtol=1e-5, atol=1e-6)


def test_vector_lloyd_from_jax_draws(blobs):
    X, _, jkern, _ = blobs
    want = jb.rff_kmeans(jax.random.PRNGKey(5), X, jkern.gamma, K, m=256)
    Z, k_c = _jax_rff(X, jkern.gamma, 256, jax.random.PRNGKey(5))
    idx = _t(jax.random.choice(k_c, X.shape[0], (K,), replace=False))
    got, d2 = tb._vector_lloyd(Z, Z[idx.long()], K, 20)
    _check(got, want, d2)


def test_svd_rff_from_jax_draws(blobs):
    """U's column signs are free (eigh), which moves no distance: labels and
    objective are compared, never U."""
    X, _, jkern, _ = blobs
    want = jb.svd_rff_kmeans(jax.random.PRNGKey(5), X, jkern.gamma, K, m=256)
    Z, k_c = _jax_rff(X, jkern.gamma, 256, jax.random.PRNGKey(5))
    U = tb._top_singular_directions(Z, K)
    idx = _t(jax.random.choice(k_c, X.shape[0], (K,), replace=False))
    got, d2 = tb._vector_lloyd(U, U[idx.long()], K, 20)
    _check(got, want, d2)


def test_two_stage_from_jax_draws(blobs):
    X, _, jkern, kern = blobs
    k_s, k_c = jax.random.split(jax.random.PRNGKey(5))
    want = jb.two_stage(jax.random.PRNGKey(5), X, jkern, K, l=128)
    idx = _t(jax.random.choice(k_s, X.shape[0], (128,), replace=False)).long()
    labels0 = _t(jax.random.randint(k_c, (128,), 0, K))
    Xt = _t(X)
    S = Xt[idx]
    K_SS = kern.gram(S, S)
    sample, _ = tb._exact_lloyd(K_SS, kern.diag(S), labels0, K, 20)
    got, d2 = tb._propagate(kern.gram(Xt, S), K_SS, kern.diag(Xt), sample.labels, K)
    _check(got, want, d2)


def test_onehot_mean_equals_the_references():
    labels = np.random.default_rng(1).integers(0, 7, 300)
    want_M, want_n = jb._onehot_mean(jnp.asarray(labels), 9, jnp.float32)
    M, n_c = tb._onehot_mean(torch.from_numpy(labels), 9, torch.float32)
    np.testing.assert_array_equal(M.numpy(), np.asarray(want_M))
    np.testing.assert_array_equal(n_c.numpy(), np.asarray(want_n))


def test_baselines_are_deterministic_and_int32(blobs):
    X, _, _, kern = blobs
    Xt = _t(X)
    a = tb.approx_kkm(3, Xt, kern, K, l=64)
    b = tb.approx_kkm(3, Xt, kern, K, l=64)
    assert a.labels.dtype == torch.int32 and torch.equal(a.labels, b.labels)
    assert float(a.objective) == float(b.objective)


# ------------------------------- tests/test_kkmeans.py, held by NMI


def test_all_baselines_run_and_order_sanely(blobs):
    X, y, _, kern = blobs
    Xt = _t(X)
    Kt = kern.gram(Xt, Xt)
    scores = {
        "exact": nmi(tb.exact_kernel_kmeans(5, Kt, kern.diag(Xt), K).labels, y),
        "akkm": nmi(tb.approx_kkm(5, Xt, kern, K, l=128).labels, y),
        "rff": nmi(tb.rff_kmeans(5, Xt, kern.gamma, K, m=256).labels, y),
        "svrff": nmi(tb.svd_rff_kmeans(5, Xt, kern.gamma, K, m=256).labels, y),
        "2stage": nmi(tb.two_stage(5, Xt, kern, K, l=128).labels, y),
    }
    assert all(0.0 <= v <= 1.0 for v in scores.values()), scores
    assert scores["exact"] > 0.8, scores


def test_apnc_close_to_exact_kernel_kmeans(blobs):
    X, _, _, kern = blobs
    Xt = _t(X)
    exact = tb.exact_kernel_kmeans(2, kern.gram(Xt, Xt), kern.diag(Xt), K)
    res, _ = tkk.fit_predict(2, Xt, kern, K, tkk.APNCConfig(method="nystrom", l=160, m=128),
                             device="cpu")
    assert nmi(res.labels, exact.labels) > 0.85


def test_kernel_kmeans_beats_vector_kmeans_on_rings():
    """Kernel k-means can separate concentric rings (best over seeds = 1.0);
    plain k-means never can (as tests/test_kkmeans.py holds the JAX package)."""
    X, y = tsyn.rings(3, 600, k=2, noise=0.03, gap=4.0, device="cpu")
    kern = Kernel("rbf", gamma=1.0)
    cfg = tkk.APNCConfig(method="nystrom", l=200, m=128, n_init=1)
    kkm_best = max(nmi(tkk.fit_predict(s, X, kern, 2, cfg, device="cpu")[0].labels, y)
                   for s in range(4))
    vec_best = max(nmi(tb._vector_kmeans(s, X, 2, 20).labels, y) for s in range(4))
    assert kkm_best > 0.95, (kkm_best, vec_best)
    assert vec_best < 0.4, vec_best


def test_predict_assigns_held_out_points(blobs):
    X, y, _, kern = blobs
    Xt = _t(X)
    res, coeffs = tkk.fit_predict(6, Xt[:600], kern, K,
                                  tkk.APNCConfig(method="nystrom", l=128, m=64), device="cpu")
    held = tkk.predict(Xt[600:], coeffs, res.centroids, device="cpu")
    assert nmi(held, y[600:]) > 0.85


@pytest.mark.parametrize("method,m", [("nystrom", 64), ("sd", 256)])
def test_apnc_recovers_blobs(blobs, method, m):
    X, y, _, kern = blobs
    res, _ = tkk.fit_predict(1, _t(X), kern, K, tkk.APNCConfig(method=method, l=128, m=m),
                             device="cpu")
    assert nmi(res.labels, y) > 0.9


# ---------------------------- the legacy drivers, from the same params and init


def _jax_params_torch(params):
    return apnc_params_from_numpy(np.asarray(params.landmarks), np.asarray(params.R),
                                  dataclasses.asdict(params.kernel), params.discrepancy,
                                  device="cpu")


@pytest.mark.parametrize("method", ["nystrom", "sd"])
def test_fit_predict_matches_jax_from_same_params_and_init(blobs, method, monkeypatch):
    """The port's fit_predict over the JAX package's params and its k-means++
    inits of the n_init = 3 restarts reaches its labels, iterations and
    inertia: the restart selection and the embed / Lloyd composition."""
    X, _, jkern, kern = blobs
    cfg = dict(method=method, l=128, m=64, n_init=3)
    key = jax.random.PRNGKey(4)
    want, jparams = jkk.fit_predict(key, X, jkern, K, jkk.APNCConfig(**cfg))
    k_fit, k_cluster = jax.random.split(key)
    Yj = jkk.apnc_embed(X, jparams)
    inits = [torch.from_numpy(np.array(j_kmeanspp(jax.random.fold_in(k_cluster, r), Yj, K,
                                                  jparams.discrepancy)))
             for r in range(3)]
    calls = iter(inits)
    monkeypatch.setattr(tkk, "fit_coefficients", lambda *a: _jax_params_torch(jparams))
    monkeypatch.setattr("repro_torch.core.lloyd.kmeanspp_init", lambda *a: next(calls))
    got, params = tkk.fit_predict(4, _t(X), kern, K, tkk.APNCConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)
    # predict of held-out rows from the same params and centroids
    Xq = np.asarray(X[::7]) + 0.05
    want_q = jkk.predict(jnp.asarray(Xq), jparams, want.centroids)
    got_q = tkk.predict(Xq, params, got.centroids, device="cpu")
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


@pytest.mark.parametrize("mode", ["exact", "minibatch"])
def test_stream_fit_predict_matches_jax_from_same_params_and_init(blobs, mode, monkeypatch):
    X, _, jkern, kern = blobs
    Xn = np.array(X)
    key = jax.random.PRNGKey(9)
    cfg = dict(method="nystrom", l=64, m=32, iters=20)
    want, jparams = j_stream_fit_predict(key, JBlockStore.from_array(Xn, 128), jkern, K,
                                         jkk.APNCConfig(**cfg), mode=mode, landmark_sample=256)
    _, _, k_cluster = jax.random.split(key, 3)
    k_res, k_pp = jax.random.split(k_cluster)
    sample = jnp.asarray(j_reservoir(JBlockStore.from_array(Xn, 128), 1024,
                                     seed=int(k_res[-1])))
    init = j_kmeanspp(k_pp, jkk.apnc_embed(sample, jparams), K, jparams.discrepancy)
    monkeypatch.setattr(tkk, "fit_coefficients", lambda *a: _jax_params_torch(jparams))
    monkeypatch.setattr(tlloyd, "kmeanspp_init", lambda *a: torch.from_numpy(np.array(init)))
    got, _ = tlloyd.stream_fit_predict(9, BlockStore.from_array(Xn, 128), kern, K,
                                       tkk.APNCConfig(**cfg), mode=mode, landmark_sample=256,
                                       device="cpu")
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert got.iters == want.iters and got.rows_seen == want.rows_seen
    np.testing.assert_allclose(got.inertia, float(want.inertia), rtol=1e-5)
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=1e-5)


def test_stream_fit_predict_splits_its_seed_three_ways(blobs):
    """Same seed, same result; the sample, the fit and the clustering take
    three different seeds."""
    X, y, _, kern = blobs
    store = BlockStore.from_array(np.asarray(X), 128)
    cfg = tkk.APNCConfig(l=64, m=32)
    a, pa = tlloyd.stream_fit_predict(1, store, kern, K, cfg, landmark_sample=256, device="cpu")
    b, pb = tlloyd.stream_fit_predict(1, store, kern, K, cfg, landmark_sample=256, device="cpu")
    np.testing.assert_array_equal(a.labels, b.labels)
    assert torch.equal(pa.landmarks, pb.landmarks)
    assert nmi(a.labels, y) > 0.9
    with pytest.raises(ValueError, match="unknown mode"):
        tlloyd.stream_fit_predict(1, store, kern, K, cfg, mode="x", device="cpu")


def test_legacy_config_has_no_pallas_flag():
    """`use_pallas` and bare-bool policies are not carried over."""
    fields = {f.name for f in dataclasses.fields(tkk.APNCConfig)}
    assert fields == {f.name for f in dataclasses.fields(jkk.APNCConfig)} - {"use_pallas"}
    assert tkk.APNCConfig().compute.kernels is None
    with pytest.raises(TypeError):
        tkk.apnc_embed(torch.zeros((2, 3)), None, True)


def test_model_predict_is_the_legacy_predict(blobs):
    from repro_torch.api import KernelKMeans

    X, _, _, _ = blobs
    est = KernelKMeans(K, l=64, m=32, device="cpu").fit(np.asarray(X))
    model = est.model_
    Xq = _t(X[:100])
    got = tkk.predict(Xq, model.params, model.centroids, device="cpu")
    assert torch.equal(got, model.predict(Xq, device="cpu"))


# ----------------------------------------------------------------- the shims


def test_shims_warn_and_delegate_bit_for_bit(blobs):
    from repro_torch.embed.apnc import fit_nystrom, fit_sd, sample_landmarks

    X, _, _, kern = blobs
    Xt = _t(X)
    with pytest.warns(DeprecationWarning, match="core.nystrom.fit is deprecated"):
        a = tnys.fit(3, Xt, kern, l=64, m=32)
    b = fit_nystrom(3, Xt, kern, l=64, m=32)
    assert torch.equal(a.landmarks, b.landmarks) and torch.equal(a.R, b.R)
    with pytest.warns(DeprecationWarning, match="core.stable.fit is deprecated"):
        a = tstable.fit(3, Xt, kern, l=64, m=32, t=20)
    b = fit_sd(3, Xt, kern, l=64, m=32, t=20)
    assert torch.equal(a.landmarks, b.landmarks) and torch.equal(a.R, b.R)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        L = tnys.sample_landmarks(torch.Generator().manual_seed(2), Xt, 50)
    assert torch.equal(L, sample_landmarks(torch.Generator().manual_seed(2), Xt, 50))


# -------------------------------------------------------- the synthetic data


def _jax_blob_draws(key, n, d, k, separation, anisotropy=0.5):
    kc, ka, kl, kn, kw = jax.random.split(key, 5)
    centers = jax.random.normal(kc, (k, d)) * separation
    scales = 1.0 + anisotropy * jax.random.uniform(ka, (k, d))
    labels = jax.random.randint(kl, (n,), 0, k)
    noise = jax.random.normal(kn, (n, d))
    if d <= 2048:
        warp = _t(jax.random.normal(kw, (d, d)) / jnp.sqrt(d))
    else:
        ku, kv = jax.random.split(kw)
        warp = (_t(jax.random.normal(ku, (d, 256)) / jnp.sqrt(d)),
                _t(jax.random.normal(kv, (256, d)) / jnp.sqrt(256)))
    return _t(centers), _t(scales), _t(labels).long(), _t(noise), warp


@pytest.mark.parametrize("n,d,k,warp", [(500, 12, 5, False), (300, 256, 10, True),
                                        (40, 2100, 7, True)])
def test_blobs_from_jax_draws(n, d, k, warp):
    key = jax.random.PRNGKey(11)
    want_X, want_y = jsyn.gaussian_blobs(key, n, d, k, separation=2.0, warp=warp)
    centers, scales, labels, noise, R = _jax_blob_draws(key, n, d, k, 2.0)
    X, y = tsyn._blobs_from_draws(centers, scales, labels, noise, R if warp else None)
    assert X.dtype == torch.float32 and y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    want_X = np.asarray(want_X)
    np.testing.assert_allclose(X.numpy(), want_X, rtol=1e-5, atol=1e-5 * np.abs(want_X).max())


def test_paper_standin_from_jax_draws():
    """The JAX package's stand-in (its warp and the dataset's separation),
    rebuilt from its draws by the port's arithmetic."""
    want_X, want_y, ds = jsyn.paper_standin("usps", 3, n_override=300)
    centers, scales, labels, noise, R = _jax_blob_draws(jax.random.PRNGKey(3), 300, ds.d, ds.k,
                                                        ds.separation)
    X, y = tsyn._blobs_from_draws(centers, scales, labels, noise, R)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    want_X = np.asarray(want_X)
    np.testing.assert_allclose(X.numpy(), want_X, rtol=1e-5, atol=1e-5 * np.abs(want_X).max())


def test_paper_standin_shape_and_config():
    X, y, ds = tsyn.paper_standin("usps", 3, n_override=300, device="cpu")
    jds = jsyn.PAPER_DATASETS["usps"]
    assert dataclasses.asdict(ds) == dataclasses.asdict(jds)
    assert X.shape == (300, jds.d) and X.dtype == torch.float32
    assert y.dtype == torch.int32 and int(y.min()) >= 0 and int(y.max()) < jds.k
    X2, y2, _ = tsyn.paper_standin("usps", 3, n_override=300, device="cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    Xb, _, _ = tsyn.paper_standin("imagenet-50k", 0, n_override=20, device="cpu")
    assert Xb.shape == (20, 900)


def test_rings_from_jax_draws():
    key = jax.random.PRNGKey(3)
    want_X, want_y = jsyn.rings(key, 600, k=2, noise=0.03, gap=4.0)
    kr, ka, kn2 = jax.random.split(key, 3)
    labels = _t(jax.random.randint(kr, (600,), 0, 2))
    u = _t(jax.random.uniform(ka, (600,)))
    eps = _t(jax.random.normal(kn2, (600, 2)))
    X, y = tsyn._rings_from_draws(labels, u, eps, 0.03, 4.0)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(X.numpy(), np.asarray(want_X), rtol=1e-5, atol=1e-5)


def test_rings_blocks_equal_the_references():
    want_X, want_y = jsyn.rings_blocks(4, 1000, 3, block_rows=300)
    X, y = tsyn.rings_blocks(4, 1000, 3, block_rows=300)
    assert (X.num_blocks, y.d) == (want_X.num_blocks, 1)
    for i in range(X.num_blocks):
        np.testing.assert_array_equal(X.get(i), want_X.get(i))
        np.testing.assert_array_equal(y.get(i), want_y.get(i))
    np.testing.assert_array_equal(X.materialize(), want_X.materialize())
    np.testing.assert_array_equal(y.materialize(), want_y.materialize())


@pytest.mark.parametrize("n,l,d", [(300, 300, 12), (257, 64, 900)])
def test_gram_in_place_keeps_the_out_of_place_bits(n, l, d):
    """The rbf Gram is built in place (a 50,000-row Gram is 10 GB); its bits
    are those of the out-of-place expression."""
    rng = np.random.default_rng(n)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    Z = X[:l] + 0.01
    xx = torch.sum(X * X, dim=-1, keepdim=True)
    zz = torch.sum(Z * Z, dim=-1, keepdim=True).T
    want = torch.clamp(xx - 2.0 * (X @ Z.T) + zz, min=0.0)
    assert torch.equal(Kernel("rbf", gamma=0.3).gram(X, Z), torch.exp(-0.3 * want))
    assert torch.equal(Kernel("rbf", gamma=0.3).gram(X, X)[:5, :5],
                       torch.exp(-0.3 * torch.clamp(xx - 2.0 * (X @ X.T) + xx.T, min=0.0))[:5, :5])


@pytest.mark.parametrize("name", ["exact_kernel_kmeans", "approx_kkm", "rff_kmeans",
                                  "svd_rff_kmeans", "two_stage"])
def test_final_d2_rebuilds_the_distances_of_the_labels(blobs, name):
    """`_final_d2` (what a card-vs-CPU comparison reads to tell a near tie)
    replays a run and gives back the distances whose argmin is its labels."""
    X, _, _, kern = blobs
    Xt = _t(X)
    run = dict(
        exact_kernel_kmeans=lambda: tb.exact_kernel_kmeans(5, kern.gram(Xt, Xt), kern.diag(Xt), K),
        approx_kkm=lambda: tb.approx_kkm(5, Xt, kern, K, l=128),
        rff_kmeans=lambda: tb.rff_kmeans(5, Xt, kern.gamma, K, m=64),
        svd_rff_kmeans=lambda: tb.svd_rff_kmeans(5, Xt, kern.gamma, K, m=64),
        two_stage=lambda: tb.two_stage(5, Xt, kern, K, l=128))[name]
    res = run()
    d2 = tb._final_d2(name, 5, Xt, kern, K, l=128, m=64)
    assert torch.equal(torch.argmin(d2, dim=-1).to(torch.int32), res.labels)
