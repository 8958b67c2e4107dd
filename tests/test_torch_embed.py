"""The embedding family's public surface in the port against the JAX package's:
`EmbeddingProps` / `props` / `props_of` for every member from the same fitted
params (carried across through the serialized form), the property cases of
tests/test_embed.py (protocol surface, P4.1 where declared, the linearity
flags, `unregister_embedding` rebinding a shared params type), the toy member
and registry cases of tests/test_api.py, the deprecated `register_method` /
`get_method` and `ops` aliases, the paper's kernel settings
(`make_kernel`, `USPS_KERNEL`, `MNIST_KERNEL`) and `purity` /
`clustering_accuracy_proxy`. Everything runs on the CPU."""
from __future__ import annotations

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.embed as JE
from repro.core import kernels_fn as jkf
from repro.core import metrics as jmetrics
from repro.core.kernels_fn import Kernel as JKernel
from repro.data.synthetic import gaussian_blobs as j_gaussian_blobs
from repro_torch import embed as E
from repro_torch.api import (
    EmbeddingProps,
    KernelKMeans,
    register_kernel,
    register_method,
    resolve_kernel,
    unregister_embedding,
)
from repro_torch.core import kernels_fn as tkf
from repro_torch.core import metrics as tmetrics
from repro_torch.core.kernels_fn import Kernel
from repro_torch.kernels import ops
from repro_torch.stream.blockstore import BlockStore

CPU = torch.device("cpu")

# (registered name, kernel, fit kwargs), as tests/test_embed.py: every member
# appears, and the linear-kernel / degree-1 cases exercise P4.1.
CASES = [
    ("nystrom", dict(name="rbf", gamma=0.5), dict(l=48, m=24)),
    ("nystrom", dict(name="linear"), dict(l=48, m=24)),
    ("nystrom", dict(name="rbf", gamma=0.5), dict(l=48, m=16, q=2)),
    ("sd", dict(name="rbf", gamma=0.5), dict(l=48, m=32, t=16)),
    ("sd", dict(name="linear"), dict(l=48, m=32)),
    ("rff", dict(name="rbf", gamma=0.5), dict(l=0, m=32)),
    ("tensorsketch", dict(name="poly", degree=2, coef0=1.0), dict(l=0, m=64)),
    ("tensorsketch", dict(name="poly", degree=1, coef0=1.0), dict(l=0, m=64)),
]
IDS = [f"{n}-{k['name']}{k.get('degree', '')}{'-q2' if kw.get('q', 1) > 1 else ''}"
       for n, k, kw in CASES]
#: The cases whose member declares itself input-linear (the linear kernel,
#: degree-1 sketches); test_linearity_declared_for_the_right_members holds
#: the flags of the others.
LINEAR = [(case, i) for case, i in zip(CASES, IDS)
          if case[1]["name"] == "linear" or case[1].get("degree") == 1]


@pytest.fixture(scope="module")
def X():
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (96, 6)) * 0.8)


def _reference_params(name, kernel, kw, X):
    return JE.get_embedding(name).fit(jax.random.PRNGKey(1), X, JKernel(**kernel), **kw)


def _port_params(name, kernel, kw, X):
    """The reference's fitted params carried into the port through the
    serialized form (params_state -> params_restore)."""
    jparams = _reference_params(name, kernel, kw, X)
    arrays, config = JE.embedding_for(jparams).params_state(jparams)
    return jparams, E.get_embedding(name).params_restore(arrays, config, device=CPU)


def test_suite_covers_registry():
    assert set(E.available_embeddings()) == {name for name, _, _ in CASES}
    assert E.DEFAULT_EMBEDDING == JE.DEFAULT_EMBEDDING == "nystrom"


def test_props_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(EmbeddingProps)] == \
        [f.name for f in dataclasses.fields(JE.EmbeddingProps)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        EmbeddingProps(linear=True, discrepancy="l2").linear = False


@pytest.mark.parametrize("name,kernel,kw", CASES, ids=IDS)
def test_props_equal_the_references(name, kernel, kw, X):
    jparams, tparams = _port_params(name, kernel, kw, X)
    want = dataclasses.asdict(JE.props_of(jparams))
    assert dataclasses.asdict(E.props_of(tparams)) == want
    assert dataclasses.asdict(E.get_embedding(name).props(tparams)) == want
    assert E.get_embedding(name).kernel_families == JE.get_embedding(name).kernel_families
    assert E.get_embedding(name).landmark_free == JE.get_embedding(name).landmark_free


@pytest.mark.parametrize("name,kernel,kw", CASES, ids=IDS)
def test_protocol_surface(name, kernel, kw, X):
    _, params = _port_params(name, kernel, kw, X)
    emb = E.get_embedding(name)
    Xt = torch.from_numpy(X)
    Y = emb.transform(params, Xt)
    assert Y.shape == (X.shape[0], params.m) and Y.dtype == torch.float32
    assert bool(torch.isfinite(Y).all()) and params.d == X.shape[1]
    props = emb.props(params)
    assert props.discrepancy == params.discrepancy
    if kw.get("q", 1) > 1:
        assert props.blockwise


@pytest.mark.parametrize("name,kernel,kw", [c for c, _ in LINEAR], ids=[i for _, i in LINEAR])
def test_p41_linearity_where_declared(name, kernel, kw, X):
    """Declared-linear members commute with input-row means (the testable
    face of P4.1), within the reference's tolerance (rtol 1e-4, atol 1e-5)."""
    _, params = _port_params(name, kernel, kw, X)
    emb = E.get_embedding(name)
    assert emb.props(params).linear
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(
        emb.transform(params, Xt.mean(dim=0, keepdim=True))[0].numpy(),
        emb.transform(params, Xt).mean(dim=0).numpy(), rtol=1e-4, atol=1e-5)


def test_linearity_declared_for_the_right_members(X):
    expect = {
        ("nystrom", "linear"): True, ("nystrom", "rbf"): False,
        ("sd", "linear"): True, ("rff", "rbf"): False,
        ("tensorsketch", "poly1"): True, ("tensorsketch", "poly2"): False,
    }
    for name, kernel, kw in CASES:
        tag = kernel["name"] + str(kernel.get("degree", "") if kernel["name"] == "poly" else "")
        if (name, tag) in expect:
            _, params = _port_params(name, kernel, kw, X)
            assert E.props_of(params).linear is expect[(name, tag)], (name, tag)


def test_props_is_abstract():
    class NoProps(E.Embedding):
        name = "no-props"
        params_cls = dict

        def fit(self, seed, data, kernel, *, l, m, t=None, q=1):  # pragma: no cover
            raise NotImplementedError

        def transform(self, params, X):  # pragma: no cover
            return X

    with pytest.raises(TypeError, match="props"):
        NoProps()


def test_unregister_rebinds_shared_params_dispatch(X):
    """Removing one member of a shared params type (register_method shims
    share APNCCoefficients with nystrom / sd) must not orphan the others."""
    from repro_torch.embed.apnc import _APNCBase

    class Shadow(_APNCBase):
        name = "shadow-apnc"

        def fit(self, seed, data, kernel, *, l, m, t=None, q=1):  # pragma: no cover
            raise NotImplementedError

    E.register_embedding(Shadow)  # now owns the APNCCoefficients dispatch
    try:
        _, params = _port_params("nystrom", dict(name="rbf", gamma=0.5), dict(l=32, m=16), X)
    finally:
        E.unregister_embedding("shadow-apnc")
    assert "shadow-apnc" not in E.available_embeddings()
    assert E.embedding_for(params) is not None
    assert E.transform(params, torch.from_numpy(X)).shape == (X.shape[0], params.m)
    unregister_embedding("never-registered")  # a no-op, as in the reference


# ------------------------------------------------ tests/test_api.py cases


@pytest.fixture(scope="module")
def blobs():
    X, y = j_gaussian_blobs(jax.random.PRNGKey(0), 512, 8, 4, separation=4.0)
    return np.asarray(X), np.asarray(y)


def _est(k=4, **kw):
    kw.setdefault("l", 48)
    kw.setdefault("m", 32)
    kw.setdefault("iters", 10)
    kw.setdefault("block_rows", 128)
    return KernelKMeans(k, device="cpu", **kw)


def test_toy_embedding_full_lifecycle(blobs, tmp_path):
    """register_embedding alone makes a user-defined member work through
    fit / predict / save / load on the local and stream backends."""

    @dataclasses.dataclass
    class ToyParams:
        P: torch.Tensor  # (d, m) random projection

        @property
        def m(self):
            return self.P.shape[1]

        @property
        def d(self):
            return self.P.shape[0]

        @property
        def discrepancy(self):
            return "l2"

        def to(self, device):
            return ToyParams(P=self.P.to(device))

    class ToyEmbedding(E.Embedding):
        name = "toy-proj"
        params_cls = ToyParams

        def fit(self, seed, data, kernel, *, l, m, t=None, q=1):
            g = torch.Generator().manual_seed(int(seed))
            return ToyParams(P=torch.randn((data.shape[-1], m), generator=g).to(data.device))

        def transform(self, params, X):
            return (X @ params.P).to(torch.float32)

        def props(self, params):
            return EmbeddingProps(linear=True, discrepancy="l2", landmark_free=True)

    E.register_embedding(ToyEmbedding)
    try:
        X, _ = blobs
        est = _est(method="toy-proj").fit(X, seed=11)
        assert est.model_.meta.method == "toy-proj"
        assert E.props_of(est.model_.params).landmark_free
        assert np.array_equal(est.predict(X), est.labels_)
        est.save(tmp_path / "toy")
        loaded = KernelKMeans.load(tmp_path / "toy", device="cpu")
        assert isinstance(loaded.model_.params, ToyParams)
        assert np.array_equal(loaded.predict(X), est.labels_)
        est2 = _est(method="toy-proj", backend="stream").fit(BlockStore.from_array(X, 128),
                                                             seed=11)
        assert np.array_equal(est2.labels_, est.labels_)
    finally:
        unregister_embedding("toy-proj")
    assert "toy-proj" not in E.available_embeddings()


def test_registry_extension_and_errors():
    from repro_torch.api import KERNELS

    try:
        register_kernel("rbf_wide", lambda **kw: Kernel("rbf", gamma=0.01, **kw))
        assert resolve_kernel("rbf_wide").gamma == 0.01
    finally:
        KERNELS.pop("rbf_wide", None)
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve_kernel("nope")
    with pytest.raises(ValueError, match="unknown backend"):
        KernelKMeans(2, backend="mapreduce", device="cpu").fit(np.zeros((8, 2), np.float32))
    with pytest.raises(ValueError, match="unknown embedding"):
        KernelKMeans(2, method="magic", device="cpu").fit(np.zeros((64, 2), np.float32))
    with pytest.raises(RuntimeError, match="not fitted"):
        KernelKMeans(2, device="cpu").predict(np.zeros((4, 2), np.float32))


def test_api_surface_is_the_references():
    import repro.api as japi
    import repro_torch.api as tapi

    assert sorted(tapi.__all__) == sorted(japi.__all__)
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None, name
    from repro_torch.serving import ModelRegistry, ServingTier, Shed

    assert (tapi.ModelRegistry, tapi.ServingTier, tapi.Shed) == (ModelRegistry, ServingTier,
                                                                 Shed)
    with pytest.raises(AttributeError):
        tapi.NotAThing  # noqa: B018


# --------------------------------------------------- deprecated entry points


def test_register_method_shim_fits_like_the_references(blobs):
    """register_method wraps a bare APNC fit into a member that fits, predicts
    and unregisters; register_method and get_method warn."""
    from repro_torch.embed.apnc import fit_nystrom

    X, _ = blobs
    with pytest.warns(DeprecationWarning, match="register_method is deprecated"):
        @register_method("legacy-nys")
        def _fit(seed, data, kernel, *, l, m, t=None, q=1):
            return fit_nystrom(seed, data, kernel, l=l, m=m, q=q)
    try:
        assert "legacy-nys" in E.available_embeddings()
        legacy = _est(method="legacy-nys", kernel=Kernel("rbf", gamma=0.1)).fit(X, seed=3)
        plain = _est(method="nystrom", kernel=Kernel("rbf", gamma=0.1)).fit(X, seed=3)
        assert np.array_equal(legacy.labels_, plain.labels_)
        assert E.props_of(legacy.model_.params) == E.props_of(plain.model_.params)
        from repro_torch.api.registry import get_method

        with pytest.warns(DeprecationWarning, match="get_method is deprecated"):
            fit = get_method("legacy-nys")
        assert fit.__self__ is E.get_embedding("legacy-nys")
    finally:
        unregister_embedding("legacy-nys")
    assert "legacy-nys" not in E.available_embeddings()
    # nystrom and sd still own their shared params type
    assert E.embedding_for(plain.model_.params) in (E.get_embedding("nystrom"),
                                                    E.get_embedding("sd"))


def test_ops_aliases_warn_and_delegate_bit_for_bit(X):
    jparams, params = _port_params("nystrom", dict(name="rbf", gamma=0.5), dict(l=48, m=24), X)
    Xt = torch.from_numpy(X)
    C = Xt.new_tensor(np.random.default_rng(0).standard_normal((5, params.m)))
    pairs = [
        ("apnc_embed_block_map", (Xt, params), ops.embed_block_map),
        ("apnc_embed_assign_block", (Xt, params, C), ops.embed_assign_block),
        ("apnc_predict_block", (Xt, params, C), ops.predict_block),
    ]
    for alias, args, target in pairs:
        with pytest.warns(DeprecationWarning, match=f"ops.{alias} is deprecated"):
            got = getattr(ops, alias)(*args)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            want = target(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), alias


# ------------------------------------------------ kernels and metrics


def test_paper_kernels_are_the_references():
    for name in ("USPS_KERNEL", "MNIST_KERNEL"):
        assert dataclasses.asdict(getattr(tkf, name)) == dataclasses.asdict(getattr(jkf, name))
    for kw in (dict(name="rbf", gamma=0.3), dict(name="poly", degree=3, coef0=0.5),
               dict(name="tanh", scale=0.01, coef0=0.2), dict(name="linear")):
        assert dataclasses.asdict(tkf.make_kernel(**kw)) == \
            dataclasses.asdict(jkf.make_kernel(**kw))


def test_purity_and_accuracy_proxy_equal_the_references():
    rng = np.random.default_rng(4)
    for k in (2, 5, 9):
        truth = rng.integers(0, k, 500)
        pred = np.where(rng.random(500) < 0.7, truth, rng.integers(0, k + 1, 500))
        assert tmetrics.purity(pred, truth) == jmetrics.purity(pred, truth)
        assert tmetrics.clustering_accuracy_proxy(pred, truth) == \
            jmetrics.clustering_accuracy_proxy(pred, truth)
    assert tmetrics.purity([0, 1, 1, 0], [1, 0, 0, 1]) == 1.0
