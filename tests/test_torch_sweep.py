"""The port's embed-once sweep against the JAX package's, and its own
keystones: the multi-candidate engine fed the same numpy Y blocks and inits
under every codec, sweep == fit inside the port, the selection rule, the
int8 cache against the f32 one, the two staged-cache repairs, the bf16
transform, the persisted embed stage and its resume, and what is not ported
yet. Everything runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.embed import get_embedding as j_get_embedding
from repro.embed.base import transform as j_transform
from repro.policy import ComputePolicy as JPolicy
from repro.stream import blockstore as jbs
from repro.sweep import engine as jsweep
from repro_torch.api import ComputePolicy, KernelKMeans, SweepResult
from repro_torch.api.backends import FitContext, ensure_embedding_cache
from repro_torch.convert import apnc_params_from_numpy
from repro_torch.embed.base import transform as t_transform
from repro_torch.stream import blockstore as tbs
from repro_torch.stream import engine
from repro_torch.stream.lloyd import stream_embed
from repro_torch.sweep import engine as tsweep

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def blobs():
    """The blobs of tests/test_cache_codec.py's sweep keystone."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((3, 5)) * 4.0
    X = np.concatenate(
        [c + 0.3 * rng.standard_normal((80, 5)) for c in centers]
    ).astype(np.float32)
    rng.shuffle(X)
    return X


@pytest.fixture(scope="module")
def staged_y():
    """An embedded-looking Y (eigenvalue-scaled columns) and k-means++-like
    inits for k = 3 and 5, two restarts each, as numpy."""
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((5, 12)) * 3.0
    lab = rng.integers(0, 5, 700)
    Y = (centers[lab] + rng.standard_normal((700, 12))) * np.linspace(2.0, 0.2, 12)
    Y = Y.astype(np.float32)
    inits = [np.stack([Y[rng.choice(700, k, replace=False)] for _ in range(2)]) for k in (3, 5)]
    return Y, inits


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_sweep_lloyd_matches_jax(staged_y, codec, disc):
    Y, inits = staged_y
    jstore = jbs.BlockStore.empty(n=700, d=12, block_rows=128, codec=codec)
    tstore = tbs.BlockStore.empty(n=700, d=12, block_rows=128, codec=codec)
    for i in range(tstore.num_blocks):
        jstore.put(i, Y[i * 128:(i + 1) * 128])
        tstore.put(i, Y[i * 128:(i + 1) * 128])
    want = jsweep.sweep_lloyd(jstore, [jnp.asarray(c) for c in inits], disc, iters=12,
                              policy=JPolicy(pallas=False))
    got = tsweep.sweep_lloyd(tstore, [torch.from_numpy(c) for c in inits], disc, iters=12,
                             device=CPU)
    for i in range(2):
        for r in range(2):
            np.testing.assert_array_equal(got.labels[i][r], want.labels[i][r])
    np.testing.assert_array_equal(got.iters, want.iters)
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(got.centroids[i].numpy(), np.asarray(want.centroids[i]),
                                   rtol=1e-5, atol=1e-5)


def test_sweep_lloyd_local_matches_stream(staged_y):
    Y, inits = staged_y
    store = tbs.BlockStore.from_array(Y, 128)
    ts = [torch.from_numpy(c) for c in inits]
    stream = tsweep.sweep_lloyd(store, ts, "l2", iters=12, device=CPU)
    local = tsweep.sweep_lloyd_local(torch.from_numpy(Y), ts, "l2", iters=12)
    for i in range(2):
        for r in range(2):
            np.testing.assert_array_equal(stream.labels[i][r], local.labels[i][r])
    np.testing.assert_allclose(stream.inertia, local.inertia, rtol=1e-5)


def test_sweep_pass_feeds_every_candidate(staged_y):
    """One engine pass a Lloyd iteration for the whole lattice, plus the
    final assign, each over the wire form of the int8 cache."""
    Y, inits = staged_y
    store = tbs.BlockStore.empty(n=700, d=12, block_rows=128, codec="int8")
    for i in range(store.num_blocks):
        store.put(i, Y[i * 128:(i + 1) * 128])
    engine.reset_counters()
    out = tsweep.sweep_lloyd(store, [torch.from_numpy(c) for c in inits], "l2", iters=12,
                             device=CPU)
    assert engine.PASS_COUNTS["sweep_lloyd"] == out.passes + 1
    assert out.passes == int(out.iters.max())
    assert engine.COUNTERS["bytes_h2d"] == (out.passes + 1) * (700 * 12 + 6 * 12 * 4)


# ------------------------------------------------------------ the estimator


def _est(method, backend, **kw):
    extra = dict(t=8) if method == "sd" else {}
    return KernelKMeans(3, method=method, l=32, m=16, iters=8, block_rows=64,
                        backend=backend, device="cpu", **extra, **kw)


@pytest.mark.parametrize("backend", ["local", "stream"])
@pytest.mark.parametrize("method", ["nystrom", "sd", "rff"])
def test_single_candidate_sweep_equals_fit(blobs, method, backend):
    data = tbs.BlockStore.from_array(blobs, 64) if backend == "stream" else blobs
    fit = _est(method, backend).fit(data, seed=3)
    est = _est(method, backend)
    res = est.sweep(data, k_grid=[3], restarts=1, seed=3)
    np.testing.assert_array_equal(res.best_labels, fit.labels_)
    np.testing.assert_array_equal(est.labels_, fit.labels_)
    assert est.inertia_ == pytest.approx(fit.inertia_, rel=1e-6)
    assert est.n_iter_ == fit.n_iter_ and est.backend_ == backend
    assert torch.equal(est.model_.centroids, fit.model_.centroids)
    assert set(est.phases_) == {"host_view", "reservoir", "embed_fit", "embed_cache", "seed",
                                "lloyd"}


def test_sweep_restarts_match_fit_n_init(blobs):
    store = tbs.BlockStore.from_array(blobs, 64)
    fit = _est("nystrom", "stream", n_init=3).fit(store, seed=5)
    est = _est("nystrom", "stream")
    res = est.sweep(store, k_grid=[3], restarts=3, seed=5)
    np.testing.assert_array_equal(est.labels_, fit.labels_)
    assert min(res.inertia_table()[3]) == pytest.approx(fit.inertia_, rel=1e-6)


def test_multi_candidate_table_and_adoption(blobs):
    store = tbs.BlockStore.from_array(blobs, 64)
    est = _est("nystrom", "stream", policy=ComputePolicy(cache_dtype="int8"))
    res = est.sweep(store, k_grid=[2, 3, 4], restarts=2, seed=0)
    assert res.inertia.shape == (3, 2) and res.k_grid == (2, 3, 4)
    assert (res.best_k_index, res.best_restart) == SweepResult.select_best(res.inertia)
    assert est.model_ is res.best and est.inertia_ == res.best_inertia
    for k, r, model, inertia in res.candidates():
        assert model.k == k == model.meta.k and model.meta.n_init == 2
        lab = res.labels[res.k_grid.index(k)][r]
        assert lab.shape == (store.n,) and 0 <= lab.min() and lab.max() < k
        assert np.isfinite(inertia)
    np.testing.assert_array_equal(est.predict(store), est.labels_)


def test_select_best_tie_break():
    assert SweepResult.select_best(np.asarray([[2.0, 1.0], [1.0, 3.0]])) == (0, 1)
    assert SweepResult.select_best(np.full((3, 4), 7.5)) == (0, 0)
    assert SweepResult.select_best(np.asarray([[3.0, 2.0], [2.0, 2.0]])) == (0, 1)


def test_int8_sweep_agrees_with_f32(blobs):
    """The keystone of tests/test_cache_codec.py in the port: the sweep over
    the int8 cache keeps >= 0.999 of the f32 sweep's labels."""
    runs = {c: KernelKMeans(3, method="rff", m=32, iters=6, block_rows=64, backend="stream",
                            device="cpu", policy=ComputePolicy(cache_dtype=c)).sweep(
        blobs, k_grid=[3], restarts=2, seed=7) for c in ("f32", "int8")}
    for r in range(2):
        assert (runs["f32"].labels[0][r] == runs["int8"].labels[0][r]).mean() >= 0.999


# ------------------------------------------------------------ the repairs


def test_local_sweep_clusters_the_resident_f32_y(blobs):
    """Resident input is embedded into a resident f32 Y whatever the cache
    codec, as in the JAX package: a local sweep under int8 is the f32 one."""
    a = _est("nystrom", "local").sweep(blobs, k_grid=[2, 3], restarts=2, seed=1)
    b = _est("nystrom", "local", policy=ComputePolicy(cache_dtype="int8")).sweep(
        blobs, k_grid=[2, 3], restarts=2, seed=1)
    np.testing.assert_array_equal(a.inertia, b.inertia)
    for i in range(2):
        for r in range(2):
            np.testing.assert_array_equal(a.labels[i][r], b.labels[i][r])
    est = _est("nystrom", "local")
    ctx = est._prepare(blobs, 1, CPU, "local")
    ensure_embedding_cache(ctx)
    assert ctx.y_store is None and ctx.y_array.dtype == torch.float32
    assert ensure_embedding_cache(ctx).y_array is ctx.y_array  # idempotent


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_stream_embed_stages_under_the_policy_codec(blobs, codec):
    est = _est("nystrom", "stream").fit(tbs.BlockStore.from_array(blobs, 64))
    store = tbs.BlockStore.from_array(blobs, 64)
    pol = ComputePolicy(cache_dtype=codec)
    staged = stream_embed(store, est.model_.params, policy=pol, device=CPU)
    f32 = stream_embed(store, est.model_.params, device=CPU)
    assert staged.codec == codec and f32.codec == "f32"
    for i in range(staged.num_blocks):
        assert staged.get_encoded(i) is not None
        bound = tbs.get_codec(codec).error_bound(f32.get(i))
        assert np.all(np.abs(staged.get(i) - f32.get(i)) <= bound)
    est.policy = pol
    out = est.transform(tbs.BlockStore.from_array(blobs, 64))
    assert out.codec == codec
    ctx = FitContext(store=store, array=None, params=est.model_.params, k=3, inits=[],
                     iters=4, policy=pol, device=CPU)
    assert ensure_embedding_cache(ctx).y_store.codec == codec


# ------------------------------------------------------------ bf16 precision


def test_bf16_transform_matches_jax(blobs):
    X = jnp.asarray(blobs)
    jparams = j_get_embedding("nystrom").fit(jax.random.PRNGKey(2), X, JKernel("rbf", gamma=0.1),
                                             l=48, m=16)
    want = np.asarray(j_transform(jparams, X, JPolicy(pallas=False, precision="bf16")))
    tparams = apnc_params_from_numpy(np.asarray(jparams.landmarks), np.asarray(jparams.R),
                                     dataclasses.asdict(jparams.kernel), jparams.discrepancy,
                                     device="cpu")
    got = t_transform(tparams, torch.from_numpy(blobs), ComputePolicy(precision="bf16"))
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2 * scale)
    f32 = t_transform(tparams, torch.from_numpy(blobs))
    assert not torch.equal(got, f32)  # the bf16 route really ran


# ------------------------------------------------------------ not ported


def test_what_is_not_ported_raises(blobs, staged_y):
    """What a sweep still rejects; the sharded sweep is ported and equals
    `sweep_lloyd`: labels and iterations exactly, centroids and inertia
    within rtol 1e-5 (only the grouping of the float sums differs)."""
    from repro_torch.launch.mesh import make_host_mesh

    store = tbs.BlockStore.from_array(blobs, 64)
    with pytest.raises(ValueError, match="embed-once sweep"):
        _est("nystrom", "minibatch").sweep(store, k_grid=[3])
    mesh = make_host_mesh(data=4, model=1)
    shard = _est("nystrom", "stream_shard", mesh=mesh).sweep(store, k_grid=[3], restarts=2,
                                                             seed=5)
    single = _est("nystrom", "stream").sweep(store, k_grid=[3], restarts=2, seed=5)
    assert shard.backend == "stream_shard"
    for got, want in zip(shard.labels[0], single.labels[0]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(shard.inertia, single.inertia, rtol=1e-5)
    Y, inits = staged_y
    y_store = tbs.BlockStore.from_array(Y, 64)
    t_inits = [torch.from_numpy(c) for c in inits]
    want = tsweep.sweep_lloyd(y_store, t_inits, "l2", iters=12, device="cpu")
    got = tsweep.sweep_lloyd_sharded(y_store, t_inits, "l2", iters=12, devices=["cpu"] * 4)
    np.testing.assert_array_equal(got.iters, want.iters)
    for i in range(len(inits)):
        for r in range(2):
            np.testing.assert_array_equal(got.labels[i][r], want.labels[i][r])
        np.testing.assert_allclose(got.centroids[i].numpy(), want.centroids[i].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-5)
    with pytest.raises(ValueError, match="at least one candidate"):
        _est("nystrom", "stream").sweep(store, k_grid=[])
    with pytest.raises(ValueError, match="restarts"):
        _est("nystrom", "stream").sweep(store, k_grid=[3], restarts=0)


# ------------------------------------------------- the embed stage and resume


@pytest.mark.parametrize("codec", ["f32", "int8"])
@pytest.mark.parametrize("backend", ["local", "stream"])
def test_resume_skips_the_embedding_pass(blobs, tmp_path, codec, backend):
    """A sweep rerun with the same seed and checkpoint_dir loads the staged
    Y: no phase 1, no cache_embedding pass, bit-identical candidates."""
    data = tbs.BlockStore.from_array(blobs, 64) if backend == "stream" else blobs
    pol = ComputePolicy(cache_dtype=codec)
    engine.reset_counters()
    est1 = _est("nystrom", backend, policy=pol)
    r1 = est1.sweep(data, k_grid=[2, 3], restarts=2, seed=17, checkpoint_dir=tmp_path)
    assert engine.PASS_COUNTS["cache_embedding"] == (backend == "stream")
    assert not r1.resumed and {"stage_load", "stage_save", "embed_cache"} <= set(est1.phases_)
    engine.reset_counters()
    est2 = _est("nystrom", backend, policy=pol)
    r2 = est2.sweep(data, k_grid=[2, 3], restarts=2, seed=17, checkpoint_dir=tmp_path)
    assert engine.PASS_COUNTS["cache_embedding"] == 0 and r2.resumed
    assert "stage_load" in est2.phases_ and not {"embed_fit", "embed_cache"} & set(est2.phases_)
    if backend == "stream" or codec == "f32":
        # a resumed local sweep clusters the staged Y, which under int8 is
        # the decoded cache, not the resident f32 Y (as in the JAX package)
        np.testing.assert_array_equal(r1.inertia, r2.inertia)
        for a_row, b_row in zip(r1.labels, r2.labels):
            for a, b in zip(a_row, b_row):
                np.testing.assert_array_equal(a, b)
        assert torch.equal(r1.best.centroids, r2.best.centroids)
    assert est2.kernel_ == est1.kernel_
    # another seed fingerprints differently: the stage is not adopted
    engine.reset_counters()
    r3 = _est("nystrom", "stream", policy=pol).sweep(
        tbs.BlockStore.from_array(blobs, 64), k_grid=[3], restarts=1, seed=99,
        checkpoint_dir=tmp_path)
    assert engine.PASS_COUNTS["cache_embedding"] == 1 and not r3.resumed


def test_stale_or_truncated_stage_is_embedded_again(blobs, tmp_path):
    from repro_torch.sweep.stage import STAGE_DIR, load_embed_stage

    store = tbs.BlockStore.from_array(blobs, 64)
    pol = ComputePolicy(cache_dtype="int8")
    _est("nystrom", "stream", policy=pol).sweep(store, k_grid=[3], seed=4,
                                                checkpoint_dir=tmp_path)
    shape = (store.n, store.d)
    ok = dict(method="nystrom", sweep_seed=4, input_shape=shape, cache_dtype="int8", device=CPU)
    assert load_embed_stage(tmp_path, **ok) is not None
    for bad in (dict(method="sd"), dict(sweep_seed=5), dict(input_shape=(store.n - 1, 5)),
                dict(cache_dtype="f32")):
        assert load_embed_stage(tmp_path, **{**ok, **bad}) is None
    y_bin = tmp_path / STAGE_DIR / "Y.bin"
    y_bin.write_bytes(y_bin.read_bytes()[:-16 * 64])  # lose the last block's rows
    assert load_embed_stage(tmp_path, **ok) is None
    engine.reset_counters()
    res = _est("nystrom", "stream", policy=pol).sweep(store, k_grid=[3], seed=4,
                                                      checkpoint_dir=tmp_path)
    assert engine.PASS_COUNTS["cache_embedding"] == 1 and not res.resumed
    assert load_embed_stage(tmp_path, **ok) is not None  # staged again, whole


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_stage_bytes_are_the_references(staged_y, tmp_path, codec):
    """The same staged Y and params give the same Y.bin and scales.npy bytes
    and params.npz arrays in both packages; pool.npy too."""
    from repro.sweep.stage import save_embed_stage as j_save_stage
    from repro_torch.sweep.stage import STAGE_DIR, load_embed_stage, save_embed_stage

    Y, _ = staged_y
    jstore = jbs.BlockStore.empty(n=700, d=12, block_rows=128, codec=codec)
    tstore = tbs.BlockStore.empty(n=700, d=12, block_rows=128, codec=codec)
    for i in range(tstore.num_blocks):
        jstore.put(i, Y[i * 128:(i + 1) * 128])
        tstore.put(i, Y[i * 128:(i + 1) * 128])
    rng = np.random.default_rng(3)
    L, R = rng.standard_normal((1, 20, 5)), rng.standard_normal((1, 12, 20))
    kern = dict(name="rbf", gamma=0.3, degree=5, coef0=1.0, scale=1.0)
    pool = Y[:40]
    jparams = j_get_embedding("nystrom").params_restore(
        {"landmarks": L.astype(np.float32), "R": R.astype(np.float32)},
        {"kernel": {"__kernel__": kern}, "discrepancy": "l2"})
    tparams = apnc_params_from_numpy(L, R, kern, "l2", device="cpu")
    j_save_stage(tmp_path / "j", params=jparams, pool=jnp.asarray(pool),
                 seed_key=jax.random.PRNGKey(1), y_store=jstore, sweep_key=jax.random.PRNGKey(2),
                 method="nystrom", input_shape=(700, 5))
    save_embed_stage(tmp_path / "t", params=tparams, pool=torch.from_numpy(pool), s_seed=1,
                     y_store=tstore, sweep_seed=2, method="nystrom", input_shape=(700, 5))
    names = ["Y.bin", "pool.npy"] + (["scales.npy"] if codec == "int8" else [])
    for name in names:
        assert (tmp_path / "j" / STAGE_DIR / name).read_bytes() == \
            (tmp_path / "t" / STAGE_DIR / name).read_bytes(), name
    assert not (tmp_path / "t" / STAGE_DIR / "scales.npy").exists() or codec == "int8"
    with np.load(tmp_path / "j" / STAGE_DIR / "params.npz") as a, \
            np.load(tmp_path / "t" / STAGE_DIR / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    params, pool_t, s_seed, ystore = load_embed_stage(
        tmp_path / "t", method="nystrom", sweep_seed=2, input_shape=(700, 5),
        cache_dtype=codec, device=CPU)
    assert s_seed == 1 and torch.equal(pool_t, torch.from_numpy(pool))
    assert torch.equal(params.R, tparams.R) and ystore.codec == codec
    np.testing.assert_array_equal(ystore.materialize(), tstore.materialize())
    for i in range(tstore.num_blocks):
        enc = tstore.get_encoded(i)
        if enc is not None:
            np.testing.assert_array_equal(ystore.get_encoded(i).payload, enc.payload)


def test_save_after_a_sweep_serves_the_winner(blobs, tmp_path):
    """est.save() after a sweep persists the selected model; a load serves it."""
    store = tbs.BlockStore.from_array(blobs, 64)
    est = _est("nystrom", "stream")
    res = est.sweep(store, k_grid=[2, 3], restarts=2, seed=23)
    est.save(tmp_path / "best")
    served = KernelKMeans.load(tmp_path / "best", device="cpu")
    assert served.k == res.best_k and served.method == "nystrom"
    np.testing.assert_array_equal(served.predict(blobs), est.predict(blobs))
