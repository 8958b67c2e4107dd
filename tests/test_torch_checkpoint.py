"""The port's checkpoint layer against the JAX package's: the generic tree
checkpoints (the cases of tests/test_checkpoint.py, and each package reading
the other's), `ClusterModel` and `SweepResult` artifacts in both directions
for every built-in member with exactly equal CPU predictions, the legacy
APNC artifact, `load_any_model`, the Lloyd-state fingerprint and its
counters. Everything runs on the CPU."""
import dataclasses
import json
import shutil
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import gaussian_blobs
from repro.distributed import checkpoint as jck
from repro.embed import embedding_for as j_embedding_for
from repro.stream.blockstore import BlockStore as JBlockStore
from repro_torch.api import KernelKMeans
from repro_torch.api.model import ClusterModel, FitMeta
from repro_torch.distributed import checkpoint as ck
from repro_torch.embed import get_embedding
from repro_torch.launch import elastic
from repro_torch.stream.blockstore import BlockStore

CPU = torch.device("cpu")
MEMBERS = ["nystrom", "sd", "rff", "tensorsketch"]


@pytest.fixture(scope="module")
def blobs():
    X, y = gaussian_blobs(jax.random.PRNGKey(0), 512, 8, 4, separation=4.0)
    return np.asarray(X), np.asarray(y)


def _member_kwargs(method):
    if method == "tensorsketch":
        return dict(method=method, kernel="poly", kernel_params=dict(degree=2, coef0=1.0), m=32)
    if method == "rff":
        return dict(method=method, kernel=JKernel("rbf", gamma=0.05), m=16)
    return dict(method=method, l=48, m=32)


@pytest.fixture(scope="module")
def jax_fits(blobs):
    """The JAX package's local fit of each member, keyed by method."""
    X, _ = blobs
    return {m: JKernelKMeans(4, iters=10, block_rows=128, backend="local",
                             **_member_kwargs(m)).fit(X, key=jax.random.PRNGKey(3))
            for m in MEMBERS}


def _to_port(jparams, method):
    """The JAX package's params through the serialized form: the reference's
    params_state read by the port's params_restore."""
    arrays, config = j_embedding_for(jparams).params_state(jparams)
    return get_embedding(method).params_restore(arrays, config, device=CPU)


def _strict(path):
    def reject(_):
        raise AssertionError("non-strict JSON constant in manifest")

    return json.loads((Path(path) / "manifest.json").read_text(), parse_constant=reject)


# -------------------------------------------------------- the generic layer


def _trees(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"a": torch.randn((8, 4), generator=g),
                       "nested": {"b": torch.arange(6, dtype=torch.int32)}}}


def _meta_templates(tree):
    return {k: (_meta_templates(v) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=v.dtype, device="meta"))
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    trees = _trees()
    ck.save(tmp_path, 7, trees)
    assert ck.latest_step(tmp_path) == 7
    step, out = ck.restore(tmp_path, {"params": _meta_templates(trees["params"])}, device=CPU)
    assert step == 7
    assert torch.equal(out["params"]["a"], trees["params"]["a"])
    assert torch.equal(out["params"]["nested"]["b"], trees["params"]["nested"]["b"])
    assert out["params"]["nested"]["b"].dtype == torch.int32


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    ck.save(tmp_path, 1, _trees())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(tmp_path, {"params": _meta_templates(_trees()["params"])})


def test_latest_pointer_survives_partial_write(tmp_path):
    """A crashed (partial) later checkpoint never shadows a good one."""
    ck.save(tmp_path, 10, _trees())
    broken = tmp_path / ".tmp_step_20_crashed"
    broken.mkdir()
    (broken / "params.npz").write_bytes(b"garbage")
    assert ck.latest_step(tmp_path) == 10
    step, _ = ck.restore(tmp_path, {"params": _meta_templates(_trees()["params"])}, device=CPU)
    assert step == 10


def test_latest_pointer_is_validated(tmp_path):
    ck.save(tmp_path, 5, _trees())
    shutil.rmtree(tmp_path / "step_00000005")
    assert ck.latest_step(tmp_path) is None


def test_keep_last(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, _trees(), keep_last=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000004", "step_00000005"]


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    acp = ck.AsyncCheckpointer(tmp_path, keep_last=2)
    trees = _trees()
    want = trees["params"]["a"].clone()
    acp.save(3, trees)
    trees["params"]["a"].zero_()  # the caller reuses its tensor at once
    acp.wait()
    assert ck.latest_step(tmp_path) == 3
    _, out = ck.restore(tmp_path, {"params": _meta_templates(_trees()["params"])}, device=CPU)
    assert torch.equal(out["params"]["a"], want)


def test_async_checkpointer_reraises_in_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    acp = ck.AsyncCheckpointer(blocker / "sub")
    acp.save(1, _trees())
    with pytest.raises(OSError):
        acp.wait()


def test_restore_shape_mismatch_raises(tmp_path):
    ck.save(tmp_path, 1, _trees())
    bad = {"params": {"a": torch.empty((9, 9), device="meta"),
                      "nested": {"b": torch.empty((6,), dtype=torch.int32, device="meta")}}}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, bad, device=CPU)


class _Opt(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: list


def test_namedtuple_and_sequence_roundtrip(tmp_path):
    st = _Opt(step=torch.tensor(4, dtype=torch.int32), mu={"a": torch.ones(3)},
              nu=[torch.zeros(2), (torch.full((2,), 2.0), None)])
    ck.save(tmp_path, 2, {"opt": st})
    _, out = ck.restore(tmp_path, {"opt": st}, device=CPU)
    assert isinstance(out["opt"], _Opt) and int(out["opt"].step) == 4
    assert torch.equal(out["opt"].mu["a"], st.mu["a"])
    assert torch.equal(out["opt"].nu[1][0], st.nu[1][0]) and out["opt"].nu[1][1] is None
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert sorted(manifest["trees"]["opt"]) == ["mu/a", "nu/0", "nu/1/0", "step"]


def test_each_package_restores_the_others_save(tmp_path):
    """The same trees under the same keys, arrays, step and meta, whichever
    package wrote them."""
    trees = _trees(1)
    meta = {"run": "x", "lr": 0.5}
    ck.save(tmp_path / "torch", 4, trees, extra_meta=meta)
    jtrees = {"params": {"a": jnp.asarray(trees["params"]["a"].numpy()),
                         "nested": {"b": jnp.asarray(trees["params"]["nested"]["b"].numpy())}}}
    jck.save(tmp_path / "jax", 4, jtrees, extra_meta=meta)
    for name in ("torch", "jax"):
        d = tmp_path / name / "step_00000004"
        assert json.loads((d / "manifest.json").read_text()) == json.loads(
            (tmp_path / "torch" / "step_00000004" / "manifest.json").read_text())
        with np.load(d / "params.npz") as data:
            assert sorted(data.files) == ["a", "nested/b"]
    step, jout = jck.restore(tmp_path / "torch", {"params": jax.eval_shape(lambda: jtrees["params"])})
    assert step == 4
    np.testing.assert_array_equal(np.asarray(jout["params"]["a"]), trees["params"]["a"].numpy())
    np.testing.assert_array_equal(np.asarray(jout["params"]["nested"]["b"]),
                                  trees["params"]["nested"]["b"].numpy())
    step, tout = ck.restore(tmp_path / "jax", {"params": _meta_templates(trees["params"])},
                            device=CPU)
    assert step == 4
    assert torch.equal(tout["params"]["a"], trees["params"]["a"])
    assert torch.equal(tout["params"]["nested"]["b"], trees["params"]["nested"]["b"])


# ----------------------------------------------------- params serialization


@pytest.mark.parametrize("method", MEMBERS)
def test_params_state_is_the_references(jax_fits, method):
    jparams = jax_fits[method].model_.params
    want_arrays, want_config = j_embedding_for(jparams).params_state(jparams)
    tparams = _to_port(jparams, method)
    arrays, config = get_embedding(method).params_state(tparams)
    assert config == want_config
    assert sorted(arrays) == sorted(want_arrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], want_arrays[k])
        assert arrays[k].dtype == want_arrays[k].dtype


# ------------------------------------------------------------- ClusterModel


@pytest.mark.parametrize("method", MEMBERS)
def test_reference_cluster_model_loads_in_the_port(blobs, jax_fits, tmp_path, method):
    X, _ = blobs
    jm = jax_fits[method].model_
    jck.save_cluster_model(tmp_path, jm)
    model = ck.load_cluster_model(tmp_path, device=CPU)
    assert dataclasses.asdict(model.meta) == dataclasses.asdict(jm.meta)
    assert model.meta.method == method
    np.testing.assert_array_equal(model.centroids.numpy(), np.asarray(jm.centroids))
    assert float(model.inertia) == float(jm.inertia)
    # exactly the reference's labels, on the CPU
    np.testing.assert_array_equal(model.predict(X, device="cpu").numpy(),
                                  np.asarray(jm.predict(X)))
    est = KernelKMeans.load(tmp_path, device="cpu")
    np.testing.assert_array_equal(est.predict(X), np.asarray(jax_fits[method].predict(X)))
    assert (est.k, est.method, est.m) == (4, method, jm.meta.m)


@pytest.mark.parametrize("method", MEMBERS)
def test_port_cluster_model_loads_in_the_reference(blobs, jax_fits, tmp_path, method):
    X, _ = blobs
    jm = jax_fits[method].model_
    model = ClusterModel(params=_to_port(jm.params, method),
                         centroids=torch.from_numpy(np.array(jm.centroids)),
                         inertia=torch.tensor(float(jm.inertia)),
                         meta=FitMeta(**dataclasses.asdict(jm.meta)))
    path = ck.save_cluster_model(tmp_path, model)
    _strict(path)
    back = jck.load_cluster_model(tmp_path)
    assert back.meta == jm.meta
    np.testing.assert_array_equal(np.asarray(back.predict(X)),
                                  model.predict(X, device="cpu").numpy())
    served = JKernelKMeans.load(tmp_path)
    np.testing.assert_array_equal(served.predict(X), model.predict(X, device="cpu").numpy())


def test_nan_inertia_is_written_as_null_and_read_back(jax_fits, tmp_path):
    jm = jax_fits["nystrom"].model_
    tparams = _to_port(jm.params, "nystrom")
    path = ck.save_clustering_model(tmp_path / "t", tparams, torch.from_numpy(np.array(jm.centroids)))
    assert _strict(path)["meta"]["clustering"]["inertia"] is None
    assert np.isnan(float(ck.load_cluster_model(tmp_path / "t", device=CPU).inertia))
    assert np.isnan(float(jck.load_cluster_model(tmp_path / "t").inertia))
    jck.save_clustering_model(tmp_path / "j", jm.params, jm.centroids)
    params, centroids = ck.load_clustering_model(tmp_path / "j", device=CPU)
    assert torch.equal(params.R, torch.from_numpy(np.array(jm.params.R)))
    assert torch.equal(centroids, torch.from_numpy(np.array(jm.centroids)))


def test_legacy_artifact_loads_in_both(blobs, jax_fits, tmp_path):
    """An APNC artifact from before the embedding registry: no "embedding"
    key, the kernel and discrepancy as flat keys."""
    X, _ = blobs
    jm = jax_fits["nystrom"].model_
    path = jck.save_cluster_model(tmp_path, jm)
    manifest = json.loads((path / "manifest.json").read_text())
    del manifest["meta"]["clustering"]["embedding"]
    (path / "manifest.json").write_text(json.dumps(manifest))
    model = ck.load_cluster_model(tmp_path, device=CPU)
    assert model.discrepancy == "l2" and model.params.kernel.name == "rbf"
    want = np.asarray(jck.load_cluster_model(tmp_path).predict(X))
    np.testing.assert_array_equal(model.predict(X, device="cpu").numpy(), want)


def test_load_defaults_to_the_card(jax_fits, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    jck.save_cluster_model(tmp_path, jax_fits["nystrom"].model_)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelKMeans.load(tmp_path)


# -------------------------------------------------------------- SweepResult


@pytest.fixture(scope="module")
def jax_sweep(blobs, tmp_path_factory):
    X, _ = blobs
    d = tmp_path_factory.mktemp("jsweep")
    est = JKernelKMeans(4, l=48, m=32, iters=10, block_rows=128, backend="stream")
    res = est.sweep(JBlockStore.from_array(X, 128), k_grid=[3, 4], restarts=2,
                    key=jax.random.PRNGKey(5), checkpoint_dir=d)
    return d, res


def test_reference_sweep_result_loads_in_the_port(blobs, jax_sweep):
    X, _ = blobs
    d, jres = jax_sweep
    res = ck.load_sweep_result(d, device=CPU)
    assert res.k_grid == jres.k_grid and res.restarts == 2 and res.backend == "stream"
    assert (res.best_k_index, res.best_restart) == (jres.best_k_index, jres.best_restart)
    assert res.labels is None
    np.testing.assert_array_equal(res.inertia, np.asarray(jres.inertia, np.float32))
    for i in range(2):
        for r in range(2):
            np.testing.assert_array_equal(res.models[i][r].centroids.numpy(),
                                          np.asarray(jres.models[i][r].centroids))
            assert dataclasses.asdict(res.models[i][r].meta) == dataclasses.asdict(
                jres.models[i][r].meta)
    np.testing.assert_array_equal(res.best.predict(X, device="cpu").numpy(),
                                  np.asarray(jres.best.predict(X)))
    # load_any_model serves the winner of a sweep artifact
    any_model = ck.load_any_model(d, device=CPU)
    np.testing.assert_array_equal(any_model.centroids.numpy(), np.asarray(jres.best.centroids))
    r2 = elastic.restore_sweep_result(d, device=CPU)
    assert (r2.best_k_index, r2.best_restart) == (res.best_k_index, res.best_restart)


def test_port_sweep_result_loads_in_the_reference(blobs, tmp_path):
    X, _ = blobs
    est = KernelKMeans(4, l=48, m=32, iters=10, block_rows=128, backend="stream", device="cpu")
    res = est.sweep(BlockStore.from_array(X, 128), k_grid=[3, 4], restarts=2, seed=5,
                    checkpoint_dir=tmp_path)
    _strict(tmp_path / "step_00000000")
    jres = jck.load_sweep_result(tmp_path)
    assert jres.k_grid == res.k_grid and jres.restarts == 2
    assert (jres.best_k_index, jres.best_restart) == (res.best_k_index, res.best_restart)
    np.testing.assert_array_equal(np.asarray(jres.inertia), res.inertia.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jres.best.predict(X)),
                                  res.best.predict(X, device="cpu").numpy())
    np.testing.assert_array_equal(np.asarray(jck.load_any_model(tmp_path).centroids),
                                  res.best.centroids.numpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_load_any_model_reads_a_cluster_model(jax_fits, tmp_path, writer):
    jm = jax_fits["rff"].model_
    if writer == "jax":
        jck.save_cluster_model(tmp_path, jm)
    else:
        ck.save_cluster_model(tmp_path, ClusterModel(
            params=_to_port(jm.params, "rff"), centroids=torch.from_numpy(np.array(jm.centroids)),
            inertia=torch.tensor(float(jm.inertia)), meta=FitMeta(**dataclasses.asdict(jm.meta))))
    tm = ck.load_any_model(tmp_path, device=CPU)
    np.testing.assert_array_equal(tm.centroids.numpy(), np.asarray(jm.centroids))
    np.testing.assert_array_equal(np.asarray(jck.load_any_model(tmp_path).centroids),
                                  np.asarray(jm.centroids))
    assert torch.equal(elastic.restore_cluster_model(tmp_path, device=CPU).centroids,
                       tm.centroids)


# --------------------------------------------------------------- Lloyd state


def test_lloyd_fingerprint_is_the_references():
    init = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    for kw in (dict(kind="ooc"), dict(kind="minibatch", decay=0.9),
               dict(kind="ooc", cache_dtype="int8"), dict(kind="ooc", cache_dtype="f32")):
        want = jck.lloyd_fingerprint(n=100, d=3, k=5, m=7, init=jnp.asarray(init), **kw)
        assert ck.lloyd_fingerprint(n=100, d=3, k=5, m=7, init=torch.from_numpy(init), **kw) == want
    other = ck.lloyd_fingerprint(kind="ooc", n=100, d=3, k=5, m=7,
                                 init=torch.from_numpy(init + 1e-7))
    assert other["init_sha"] != jck.lloyd_fingerprint(kind="ooc", n=100, d=3, k=5, m=7,
                                                      init=init)["init_sha"]


def _state(seed):
    rng = np.random.default_rng(seed)
    return dict(centroids=rng.standard_normal((3, 4)).astype(np.float32),
                labels=rng.integers(0, 3, 50).astype(np.int32),
                trajectory=[3.5, 2.25], shifts=[0.5, 0.125])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lloyd_state_is_read_by_both_packages(tmp_path, writer):
    st = _state(0)
    fp = ck.lloyd_fingerprint(kind="minibatch", n=50, d=2, k=3, m=4, init=st["centroids"],
                              decay=0.9)
    stats = {"Z": np.ones((3, 4), np.float32), "g": np.arange(3, dtype=np.float32),
             "seen_cost": np.float32(7.5)}
    save = jck.save_lloyd_state if writer == "jax" else ck.save_lloyd_state
    ck.reset_counters()
    save(tmp_path, step=2, changed=False, fingerprint=fp, devices_used=1, stats=stats, **st)
    assert ck.COUNTERS["ckpt_saves"] == (writer == "torch")
    for load in (jck.load_lloyd_state, ck.load_lloyd_state):
        got = load(tmp_path, fingerprint=fp)
        assert got["step"] == 2 and got["changed"] is False and got["devices_used"] == 1
        np.testing.assert_array_equal(got["centroids"], st["centroids"])
        np.testing.assert_array_equal(got["labels"], st["labels"])
        assert got["trajectory"] == st["trajectory"] and got["shifts"] == st["shifts"]
        for k, v in stats.items():
            np.testing.assert_array_equal(got["stats"][k], v)


def test_mismatched_fingerprint_is_ignored_and_resumes_are_counted(tmp_path):
    st = _state(1)
    fp = ck.lloyd_fingerprint(kind="ooc", n=50, d=2, k=3, m=4, init=st["centroids"])
    ck.save_lloyd_state(tmp_path, step=1, changed=True, fingerprint=fp, devices_used=4, **st)
    ck.reset_counters()
    assert elastic.resume_lloyd_state(tmp_path, fingerprint={**fp, "k": 4}) is None
    assert ck.load_lloyd_state(tmp_path, fingerprint={**fp, "init_sha": "0" * 16}) is None
    assert ck.COUNTERS == dict(ckpt_saves=0, ckpt_resumes=0, elastic_resumes=0)
    assert elastic.resume_lloyd_state(tmp_path, fingerprint=fp, devices_used=4)["step"] == 1
    assert ck.COUNTERS["ckpt_resumes"] == 1 and ck.COUNTERS["elastic_resumes"] == 0
    elastic.resume_lloyd_state(tmp_path, fingerprint=fp, devices_used=1)  # saved under 4
    assert ck.COUNTERS["ckpt_resumes"] == 2 and ck.COUNTERS["elastic_resumes"] == 1
    for step in (2, 3, 4):  # keep_last=2 rotation
        ck.save_lloyd_state(tmp_path, step=step, changed=True, fingerprint=fp,
                            devices_used=1, **st)
    assert sorted(p.name for p in (tmp_path / ck.LLOYD_STATE_DIR).glob("step_*")) == [
        "step_00000003", "step_00000004"]


def test_reshard_restore_names_its_item(tmp_path):
    """``reshard_restore`` (once a stub naming its ROADMAP item) restores a
    train checkpoint saved on one device onto a (2, 2) mesh of CPU shards:
    every parameter and moment bit for bit, the step as saved."""
    from repro_torch import convert
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim import adamw

    cfg = reduced(get_arch("qwen1.5-0.5b"))
    model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu")
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(model, opt_cfg)
    for i, m in enumerate(state.mu.values()):
        m.fill_(float(i))
    ck.save(tmp_path, 3, convert.lm_train_state_to_numpy(model, state._replace(
        step=torch.tensor(3, dtype=torch.int32)), cfg))
    step, params, opt = elastic.reshard_restore(tmp_path, cfg, TEST_POLICY, opt_cfg,
                                                make_host_mesh(2, 2))
    assert step == 3 and int(opt.step) == 3
    for name, p in model.named_parameters():
        assert torch.equal(params.params[name].gather("cpu"), p), name
        assert torch.equal(opt.mu[name].gather("cpu"), state.mu[name]), name


# ------------------------------------------------------------- bf16 leaves


def test_a_bf16_leaf_crosses_between_the_packages_bit_for_bit(tmp_path):
    """numpy has no bfloat16: the reference's ``np.savez`` writes a bf16 leaf
    (an ml_dtypes array) as 2-byte ``V2`` records and names the dtype
    ``bfloat16`` in the manifest. The port writes the same leaf to the same
    bytes and manifest, and restores either file bit for bit (a NaN,
    infinities, -0 and a subnormal too); the reference's format read back as
    ml_dtypes bfloat16 records gives the port's bits. (The reference's own
    ``restore`` casts with ``astype``, which ml_dtypes does not offer from
    ``V2``: it raises on any bf16 leaf, its own files included.)"""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
    x[1, 0] = torch.tensor(1e-40).to(torch.bfloat16)  # a bf16 subnormal
    bits = x.view(torch.int16).numpy()
    ck.save(tmp_path / "torch", 1, {"t": {"x": x}})
    jck.save(tmp_path / "jax", 1, {"t": {"x": jnp.asarray(bits.view(jnp.bfloat16))}})
    files = {}
    for name in ("torch", "jax"):
        d = tmp_path / name / "step_00000001"
        manifest = json.loads((d / "manifest.json").read_text())
        assert manifest["trees"]["t"]["x"] == {"shape": [5, 7], "dtype": "bfloat16"}, name
        with np.load(d / "t.npz") as data:
            files[name] = data["x"]
        assert files[name].dtype == np.dtype("V2"), name
        _, out = ck.restore(tmp_path / name, {"t": {"x": torch.empty(
            (5, 7), dtype=torch.bfloat16, device="meta")}}, device=CPU)
        assert out["t"]["x"].dtype == torch.bfloat16
        assert torch.equal(out["t"]["x"].view(torch.int16), x.view(torch.int16)), name
    assert files["torch"].tobytes() == files["jax"].tobytes()
    np.testing.assert_array_equal(files["torch"].view(jnp.bfloat16).view(np.int16), bits)


@pytest.fixture
def one_thread():
    """One intra-op thread: the LM's per-token scans are tiny ops, which a
    team of threads a test worker only slows (beside five other workers the
    test below took 728 s on the default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_bf16_moment_train_state_resumes_bitwise(tmp_path, one_thread):
    """Reduced jamba with bf16 moments (jamba and command-r-plus set
    ``moments_dtype="bfloat16"``) through ``TrainLoop``: crashed at step 3
    (checkpoint at 2) and resumed, every parameter, moment and loss equals
    the uninterrupted run's, bit for bit."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import tokens
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import LoopConfig, TrainLoop

    cfg = reduced(get_arch("jamba-1.5-large-398b"))
    assert cfg.moments_dtype == "bfloat16"

    class Boom(RuntimeError):
        pass

    def fault(step):
        if step == 3 and not (tmp_path / "fired").exists():
            (tmp_path / "fired").write_text("x")
            raise Boom()

    def run(d, hook=None):
        model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu")
        opt_cfg = adamw.AdamWConfig(lr=3e-3, moments_dtype=cfg.moments_dtype)
        step = tstep.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
        loop = TrainLoop(step, lambda s: tokens.batch_iterator(cfg, 2, 16, s, "cpu"), d,
                         LoopConfig(total_steps=4, checkpoint_every=2, log_every=1),
                         fault_hook=hook)
        return loop.run(model, adamw.init(model, opt_cfg))

    p_ref, o_ref, h_ref = run(tmp_path / "a")
    with pytest.raises(Boom):
        run(tmp_path / "b", fault)
    p, o, h = run(tmp_path / "b", fault)
    ref = dict(p_ref.named_parameters())
    for name, t in p.named_parameters():
        assert o.mu[name].dtype == torch.bfloat16
        assert torch.equal(t, ref[name]), name
        assert torch.equal(o.mu[name].view(torch.int16), o_ref.mu[name].view(torch.int16))
        assert torch.equal(o.nu[name].view(torch.int16), o_ref.nu[name].view(torch.int16))
    assert int(o.step) == 4 and [r["loss"] for r in h] == [r["loss"] for r in h_ref[2:]]
