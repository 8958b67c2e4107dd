"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here carries the `gpu` marker and skips inside its
fixture when no card is present; the file imports no JAX, so it runs as it is
on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed.apnc import fit_nystrom, fit_sd
from repro_torch.kernels import apnc_assign as t_assign
from repro_torch.kernels import apnc_embed as t_embed
from repro_torch.kernels import ops, ref

KERNELS = [
    Kernel("rbf", gamma=0.05),
    Kernel("poly", degree=3, coef0=1.0),
    Kernel("tanh", scale=0.01, coef0=0.1),
    Kernel("linear"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("shape", [(515, 77), (257, 130)])
def test_embed_kernel_matches_plain(cuda, kern, q, shape):
    n, d = shape
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d)).astype(np.float32))
    params = fit_nystrom(1, X, kern, l=48, m=17, q=q).to(cuda)
    Xc = X.to(cuda)
    before = t_embed.launches
    got = ops.apnc_embed(Xc, params)
    torch.cuda.synchronize()
    assert t_embed.launches == before + q
    want = ref.apnc_embed_ref(Xc, params.landmarks, params.R, kern)
    tol = 2e-3 if kern.name == "poly" else 2e-5  # poly amplifies roundoff
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


@pytest.mark.gpu
def test_embed_kernel_bf16_and_wide_m(cuda):
    g = torch.Generator().manual_seed(3)
    X = torch.randn((300, 40), generator=g)
    L = torch.randn((700, 40), generator=g)
    R = torch.randn((600, 700), generator=g) * 0.05  # m > one launch's columns
    kern = Kernel("rbf", gamma=0.02)
    Xc, Lc, Rc = X.to(cuda), L.to(cuda), R.to(cuda)
    got = t_embed.apnc_embed_block(Xc, Lc, Rc, kern)
    want = ref.apnc_embed_ref(Xc, Lc[None], Rc[None], kern)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))
    Xb = Xc.to(torch.bfloat16)
    got = t_embed.apnc_embed_block(Xb, Lc, Rc, kern)
    want = ref.apnc_embed_ref(Xb, Lc[None], Rc[None], kern)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nkm", [(5003, 67, 70), (64, 3, 17), (20000, 164, 256)])
def test_assign_kernel_matches_plain(cuda, disc, nkm):
    n, k, m = nkm
    rng = np.random.default_rng(7)
    Y = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
    C = torch.from_numpy((rng.standard_normal((k, m)) * 2).astype(np.float32)).to(cuda)
    before = t_assign.launches
    Z, g, labels = ops.apnc_assign(Y, C, disc)
    Z2, g2, labels2 = ops.apnc_assign(Y, C, disc)
    torch.cuda.synchronize()
    assert t_assign.launches == before + 2
    Zr, gr, lr = ref.apnc_assign_ref(Y, C, disc)
    assert torch.equal(labels, lr) and torch.equal(g, gr)
    assert torch.equal(Z, Z2) and torch.equal(g, g2) and torch.equal(labels, labels2)
    torch.testing.assert_close(Z, Zr, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_local_fit_on_card_matches_cpu(cuda):
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X, _ = gaussian_blobs_blocks(0, 3000, 16, 6, block_rows=1024, separation=4.0)
    t_before = (t_embed.launches, t_assign.launches)
    gpu = KernelKMeans(6, l=128, m=64, n_init=2, kernel_params=dict(gamma=0.01)).fit(X)
    assert t_embed.launches > t_before[0] and t_assign.launches > t_before[1]
    cpu = KernelKMeans(6, l=128, m=64, n_init=2, kernel_params=dict(gamma=0.01),
                       device="cpu").fit(X)
    assert (gpu.labels_ == cpu.labels_).mean() >= 0.999
    np.testing.assert_allclose(gpu.inertia_, cpu.inertia_, rtol=1e-3)


@pytest.mark.gpu
def test_sd_fit_embeds_through_l1_kernels(cuda):
    X = torch.randn((400, 12), generator=torch.Generator().manual_seed(5))
    params = fit_sd(2, X.to(cuda), Kernel("rbf", gamma=0.1), l=64, m=16)
    Y = ops.apnc_embed(X.to(cuda), params)
    torch.testing.assert_close(
        Y, ref.apnc_embed_ref(X.to(cuda), params.landmarks, params.R, params.kernel),
        rtol=2e-5, atol=2e-5 * float(Y.abs().max()))
    C = Y[:5].clone()
    Z, g, labels = ops.apnc_assign(Y, C, "l1")
    Zr, gr, lr = ref.apnc_assign_ref(Y, C, "l1")
    assert torch.equal(labels, lr) and torch.equal(g, gr)
