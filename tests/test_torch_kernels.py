"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX kernels (interpret mode on the CPU)
and their oracles, and through the port's wrappers on CPU tensors, which
compute with the plain PyTorch versions. Tolerances are the reference's own
(tests/test_kernels_pallas.py). tests/test_torch_gpu.py holds the CUDA
kernels against the plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_fn import Kernel as JKernel
from repro.embed.apnc import fit_nystrom
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import apnc_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.kernels import apnc_assign as t_assign
from repro_torch.kernels import apnc_embed as t_embed
from repro_torch.kernels import ops as tops

KERNELS = [
    dict(name="rbf", gamma=0.05),
    dict(name="poly", degree=3, coef0=1.0),
    dict(name="tanh", scale=0.01, coef0=0.1),
    dict(name="linear"),
]


def _embed_case(kern: dict, n: int, d: int, q: int, seed: int = 0):
    X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    coeffs = fit_nystrom(jax.random.PRNGKey(1), jnp.asarray(X), JKernel(**kern),
                         l=48, m=17, q=q)
    params = apnc_params_from_numpy(
        np.asarray(coeffs.landmarks), np.asarray(coeffs.R), kern, "l2", device="cpu"
    )
    return X, coeffs, params


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k["name"])
@pytest.mark.parametrize("shape", [(64, 32), (515, 77), (257, 130)])
def test_embed_matches_jax(kern, shape, q):
    X, coeffs, params = _embed_case(kern, *shape, q)
    got = tops.apnc_embed(torch.from_numpy(X), params).numpy()
    want_pallas = np.asarray(jops.apnc_embed(jnp.asarray(X), coeffs, interpret=True))
    want_ref = np.asarray(jref.apnc_embed_ref(
        jnp.asarray(X), coeffs.landmarks, coeffs.R, coeffs.kernel))
    assert got.shape == (shape[0], 17 * q) and got.dtype == np.float32
    tol = 2e-3 if kern["name"] == "poly" else 2e-5  # poly amplifies roundoff
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_embed_bf16_input_matches_jax():
    X, coeffs, params = _embed_case(dict(name="rbf", gamma=0.05), 96, 40, 1, seed=4)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    got = tops.apnc_embed(Xb, params).numpy()
    want = np.asarray(jops.apnc_embed(
        jnp.asarray(Xb.to(torch.float32).numpy()).astype(jnp.bfloat16), coeffs,
        interpret=True))
    assert got.dtype == np.float32  # outputs are always f32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nk", [(64, 3), (515, 7), (130, 11)])
def test_assign_matches_jax(disc, nk):
    n, k = nk
    rng = np.random.default_rng(6)
    Y = rng.standard_normal((n, 70)).astype(np.float32)
    C = (rng.standard_normal((k, 70)) * 2.0).astype(np.float32)
    Z, g, labels = tops.apnc_assign(torch.from_numpy(Y), torch.from_numpy(C), disc)
    assert labels.dtype == torch.int32 and Z.shape == (k, 70) and g.shape == (k,)
    for Zw, gw, lw in (jops.apnc_assign(jnp.asarray(Y), jnp.asarray(C), disc, interpret=True),
                       jref.apnc_assign_ref(jnp.asarray(Y), jnp.asarray(C), disc)):
        np.testing.assert_array_equal(labels.numpy(), np.asarray(lw))
        np.testing.assert_array_equal(g.numpy(), np.asarray(gw))
        np.testing.assert_allclose(Z.numpy(), np.asarray(Zw), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["shape", "dtype", "disc", "noncontig"])
def test_wrappers_reject_bad_inputs(bad):
    X = torch.zeros((8, 4))
    L = torch.zeros((5, 4))
    R = torch.zeros((3, 5))
    kern = Kernel("rbf")
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            t_embed.apnc_embed_block(X, L, R.T.contiguous(), kern)
        elif bad == "dtype":
            t_assign.apnc_assign(X.double(), L.double(), "l2")
        elif bad == "disc":
            t_assign.apnc_assign(X, L, "cosine")
        else:
            t_embed.apnc_embed_block(X.T, L, R, kern)


def test_cpu_wrappers_do_not_count_launches():
    before = (t_embed.launches, t_assign.launches)
    X = torch.ones((8, 4))
    t_embed.apnc_embed_block(X, X[:5].contiguous(), torch.ones((3, 5)), Kernel("linear"))
    t_assign.apnc_assign(X, X[:2].contiguous(), "l2")
    assert (t_embed.launches, t_assign.launches) == before


def test_launch_counters_are_exact_across_threads():
    """Sixteen threads counting launches at once, with a short switch
    interval (the serving tier's dispatcher and a swap's warm-up launch
    count from two threads), lose no count: every kernel module counts
    under build.LAUNCH_LOCK."""
    import sys
    import threading

    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.kernels import lloyd_step as t_step
    from repro_torch.kernels import rff_embed as t_rff

    modules = (t_embed, t_assign, t_rff, t_flash)
    before = [mod.launches for mod in modules]
    step_before = t_step.launches["fused_apnc_step"]
    per_thread, threads = 5_000, 16
    gate = threading.Barrier(threads)

    def count():
        gate.wait()
        for _ in range(per_thread):
            for mod in modules:
                mod._count()
            t_step._count("fused_apnc_step")

    workers = [threading.Thread(target=count) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    want = per_thread * threads
    assert [mod.launches - b for mod, b in zip(modules, before)] == [want] * len(modules)
    assert t_step.launches["fused_apnc_step"] - step_before == want
    for mod, b in zip(modules, before):
        mod.launches = b
    t_step.launches["fused_apnc_step"] = step_before


def test_library_loader_builds_one_library_once_across_threads(monkeypatch):
    """Two threads reaching one library for the first time build and
    configure it once (build.load / build.configured under one lock)."""
    import threading
    import time

    from repro_torch.kernels import build

    builds, configures = [], []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.05)  # a second caller arrives while the first builds
        return {name: f"{name}.so" for name in names}

    monkeypatch.setattr(build, "build_all", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_CONFIGURED", {})
    libs = []
    workers = [threading.Thread(target=lambda: libs.append(
        build.configured("apnc_embed", configures.append))) for _ in range(8)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert builds == [("apnc_embed",)] and len(configures) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
