"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, and the stream backend and the LM serving path on the card
against the CPU. Every test here carries the `gpu` marker and skips inside its
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

    X = gaussian_blobs_blocks(0, 3000, 16, 6, block_rows=1024, separation=4.0)[0].materialize()
    t_before = (t_embed.launches, t_assign.launches)
    gpu = KernelKMeans(6, l=128, m=64, n_init=2, kernel_params=dict(gamma=0.01)).fit(X)
    assert t_embed.launches > t_before[0] and t_assign.launches > t_before[1]
    cpu = KernelKMeans(6, l=128, m=64, n_init=2, kernel_params=dict(gamma=0.01),
                       device="cpu").fit(X)
    assert (gpu.labels_ == cpu.labels_).mean() >= 0.999
    np.testing.assert_allclose(gpu.inertia_, cpu.inertia_, rtol=1e-3)


@pytest.mark.gpu
def test_resident_fit_samples_on_the_card_without_a_host_view(cuda, tmp_path):
    """A local fit of X on the card gathers its reservoir there: the landmarks
    are those of `reservoir_sample` over a host copy of X, and no copy from
    the card in the fit moves more than the labels' bytes."""
    import json

    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.api.estimator import phase1_seeds
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.embed.apnc import sample_landmarks
    from repro_torch.stream.blockstore import BlockStore
    from repro_torch.stream.reservoir import reservoir_sample

    X = torch.from_numpy(gaussian_blobs_blocks(
        0, 3000, 16, 6, block_rows=1024, separation=4.0)[0].materialize()).to(cuda)
    est = KernelKMeans(6, l=128, m=64, kernel_params=dict(gamma=0.01), block_rows=700,
                       landmark_sample=1000, random_state=3)
    est.fit(X)  # builds the kernels outside the profiled fit
    before = obs.snapshot("phase1.")
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
        est.fit(X)
        torch.cuda.synchronize()
    assert obs.delta(before, obs.snapshot("phase1."))["phase1.device_reservoir"] == 1
    s_sample, s_fit, _ = phase1_seeds(3)
    host = reservoir_sample(BlockStore.from_array(X.cpu().numpy(), 700), 1000, seed=s_sample)
    want = sample_landmarks(torch.Generator().manual_seed(s_fit), torch.from_numpy(host), 128)
    assert torch.equal(est.model_.params.landmarks.reshape(128, 16).cpu(), want)
    p.export_chrome_trace(str(tmp_path / "fit.json"))
    events = json.loads((tmp_path / "fit.json").read_text())["traceEvents"]
    dtoh = [e["args"]["bytes"] for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    assert dtoh, "the profiler saw no copy from the card (the labels come back)"
    assert max(dtoh) <= est.labels_.nbytes


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


@pytest.mark.gpu
def test_traced_sd_fit_tags_its_l1_launches_on_the_card(cuda):
    """A traced local SD fit on the card: one sd.directions span inside
    phase.embed_fit, one launch.apnc_assign span tagged l1 a Lloyd pass
    (iterations + the final assignment), and the l1 counter counting each."""
    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X = torch.from_numpy(gaussian_blobs_blocks(
        0, 6000, 32, 6, block_rows=1024, separation=3.0)[0].materialize()).to(cuda)
    est = KernelKMeans(6, method="sd", backend="local", l=128, m=64, iters=5,
                       kernel_params=dict(gamma=0.01), random_state=3)
    est.fit(X)  # builds the kernels outside the traced fit
    before = obs.snapshot("launch.")
    obs.clear_trace()
    obs.enable_tracing()
    try:
        est.fit(X)
        torch.cuda.synchronize()
    finally:
        obs.disable_tracing()
    spans = obs.TRACER.spans()
    obs.clear_trace()
    (embed_fit,) = [s for s in spans if s.name == "phase.embed_fit"]
    (directions,) = [s for s in spans if s.name == "sd.directions"]
    assert embed_fit.t0 <= directions.t0
    assert directions.t0 + directions.dur <= embed_fit.t0 + embed_fit.dur
    launches = [s for s in spans if s.name == "launch.apnc_assign"]
    assert len(launches) == est.n_iter_ + 1
    assert all(s.attrs == {"rows": 6000, "discrepancy": "l1"} for s in launches)
    counted = obs.delta(before, obs.snapshot("launch."))["launch.apnc_assign.l1"]
    assert counted == est.n_iter_ + 1


def _blob_block(n, d, k, seed, scale=1.0):
    """Well-separated blobs and their per-class means: with C the embedded
    means, every row's nearest centroid wins by a wide margin, so the kernel
    and the plain version must agree on every label."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 4.0
    lab = rng.integers(0, k, n)
    X = (centers[lab] + rng.standard_normal((n, d)).astype(np.float32)) * np.float32(scale)
    return torch.from_numpy(X), torch.from_numpy(lab)


def _class_means(Y, lab, k):
    lab = lab.to(Y.device)
    C = torch.zeros((k, Y.shape[1]), device=Y.device).index_add_(0, lab, Y)
    return (C / torch.bincount(lab, minlength=k).clamp(min=1)[:, None]).contiguous()


def _check_step(got, want, got2, cost_rtol=1e-5):
    Z, g, labels, cost = got
    Zr, gr, lr, cr = want
    assert torch.equal(labels, lr) and torch.equal(g, gr)
    assert all(torch.equal(a, b) for a, b in zip(got, got2))  # bitwise run to run
    torch.testing.assert_close(Z, Zr, rtol=1e-4, atol=1e-4 * float(Zr.abs().max()))
    torch.testing.assert_close(cost, cr, rtol=cost_rtol, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("method", ["nystrom", "sd"])
@pytest.mark.parametrize("nd", [(4096, 77, 150, 100, 67), (1003, 130, 70, 64, 9)])
def test_fused_apnc_step_matches_plain(cuda, kern, method, nd):
    from repro_torch.kernels import lloyd_step

    n, d, l, m, k = nd
    X, lab = _blob_block(n, d, k, seed=1, scale=d ** -0.5)
    fit = fit_nystrom if method == "nystrom" else fit_sd
    params = fit(4, X, kern, l=l, m=m).to(cuda)
    Xc = X.to(cuda)
    C = _class_means(ref.apnc_embed_ref(Xc, params.landmarks, params.R, kern), lab, k)
    L, R = params.landmarks[0].contiguous(), params.R[0].contiguous()
    before = lloyd_step.launches["fused_apnc_step"]
    got = lloyd_step.fused_apnc_step(Xc, L, R, C, kern, params.discrepancy)
    got2 = lloyd_step.fused_apnc_step(Xc, L, R, C, kern, params.discrepancy)
    torch.cuda.synchronize()
    assert lloyd_step.launches["fused_apnc_step"] == before + 2
    _check_step(got, ref.fused_apnc_step_ref(Xc, L, R, C, kern, params.discrepancy), got2)


@pytest.mark.gpu
@pytest.mark.parametrize("nd", [(4096, 900, 128, 164), (1003, 77, 65, 9)])
def test_rff_kernels_match_plain(cuda, nd):
    from repro_torch.embed.rff import RFFParams
    from repro_torch.kernels import lloyd_step, rff_embed

    n, d, mh, k = nd
    X, lab = _blob_block(n, d, k, seed=2, scale=d ** -0.5)
    Xc = X.to(cuda)
    W = (torch.randn((d, mh), generator=torch.Generator().manual_seed(3)) * 0.5).to(cuda)
    scale = mh ** -0.5
    before = rff_embed.launches
    Y = rff_embed.rff_embed_block(Xc, W, scale)
    Yr = ref.rff_embed_ref(Xc, W, scale)
    torch.cuda.synchronize()
    assert rff_embed.launches == before + 1
    # The projection is a sum of d products in another order than the GEMM:
    # its error is a few ulp of sum |x_i w_i|, and cos / sin pass it on with
    # slope <= 1, times the scale.
    tol = 8 * 2.0 ** -24 * d * float((Xc.abs() @ W.abs()).max()) * scale
    torch.testing.assert_close(Y, Yr, rtol=0.0, atol=tol)
    C = _class_means(Yr, lab, k)
    params = RFFParams(W=W, kernel=Kernel("rbf", gamma=0.125))
    got = ops.fused_lloyd_step(Xc, params, C)
    got2 = ops.fused_lloyd_step(Xc, params, C)
    torch.cuda.synchronize()
    assert lloyd_step.launches["fused_rff_step"] >= 2
    _check_step(got, ref.fused_rff_step_ref(Xc, W, C, scale, "l2"), got2)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["nystrom", "rff"])
def test_stream_fit_on_card_matches_cpu(cuda, method):
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.blockstore import BlockStore

    X = gaussian_blobs_blocks(0, 5000, 16, 6, block_rows=1024, separation=4.0)[0].materialize()
    kw = dict(method=method, l=128, m=64, kernel_params=dict(gamma=0.01), block_rows=1000)
    name = "fused_apnc_step" if method == "nystrom" else "fused_rff_step"
    before = lloyd_step.launches[name]
    gpu = KernelKMeans(6, backend="stream", **kw).fit(BlockStore.from_array(X, 1000))
    assert lloyd_step.launches[name] - before >= (gpu.n_iter_ + 1) * 5
    cpu = KernelKMeans(6, backend="stream", device="cpu", **kw).fit(
        BlockStore.from_array(X, 1000))
    local = KernelKMeans(6, backend="local", **kw).fit(X)
    assert (gpu.labels_ == cpu.labels_).mean() >= 0.999
    assert (gpu.labels_ == local.labels_).mean() >= 0.999
    np.testing.assert_allclose(gpu.inertia_, cpu.inertia_, rtol=1e-3)


def _encoded_blob(n, m, k, codec, seed, device):
    """A blob block staged under ``codec`` (the port's host encoder), its
    wire form on ``device`` and the class means of the decoded rows."""
    from repro_torch.stream.blockstore import get_codec
    from repro_torch.stream.engine import host_tensor

    Y, lab = _blob_block(n, m, k, seed=seed, scale=m ** -0.5)
    payload, scale = get_codec(codec).encode(Y.numpy())
    Yq = host_tensor(payload).to(device)
    sc = torch.as_tensor(np.asarray(scale, np.float32)).to(device)
    C = _class_means(ref.dequant_ref(Yq, sc), lab, k)
    return Yq, sc, C


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nkm", [(4096, 67, 24), (1003, 9, 256), (517, 13, 800)])
def test_fused_dequant_step_matches_plain(cuda, codec, disc, nkm):
    from repro_torch.kernels import lloyd_step

    n, k, m = nkm
    Yq, sc, C = _encoded_blob(n, m, k, codec, 4, cuda)
    before = lloyd_step.launches["fused_dequant_step"]
    got = lloyd_step.fused_dequant_step(Yq, sc, C, disc)
    got2 = lloyd_step.fused_dequant_step(Yq, sc, C, disc)
    torch.cuda.synchronize()
    assert lloyd_step.launches["fused_dequant_step"] == before + 2
    _check_step(got, ref.fused_dequant_step_ref(Yq, sc, C, disc), got2, cost_rtol=1e-4)
    assert torch.equal(lloyd_step.dequant_decode(Yq, sc), ref.dequant_ref(Yq, sc))


def _random_encoded(n, m, k, codec, seed, device):
    """An unclustered block staged under ``codec`` and k centroids drawn from
    other decoded rows: rows sit near several centroids, so the labels hold
    the two routes' arithmetic to the bit."""
    from repro_torch.stream.blockstore import get_codec
    from repro_torch.stream.engine import host_tensor

    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((n + k, m)) * m ** -0.5).astype(np.float32)
    payload, scale = get_codec(codec).encode(Y)
    Yq = host_tensor(payload).to(device)
    sc = torch.as_tensor(np.asarray(scale, np.float32)).to(device)
    C = ref.dequant_ref(Yq[n:], sc).contiguous()
    return Yq[:n].contiguous(), sc, C


@pytest.mark.gpu
@pytest.mark.parametrize("m", [24, 256, 800])
@pytest.mark.parametrize("n", [1, 33, 4097, 20_000])
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_fused_dequant_step_labels_equal_decode_then_assign(cuda, codec, disc, n, m):
    """The fused step's labels are bit for bit those of dequant_decode ->
    apnc_assign (the same decode, the epilogue repeats apnc_assign.cu), and
    two launches are bitwise equal; n = 20,000 puts several tiles on a CTA."""
    from repro_torch.kernels import lloyd_step

    Yq, sc, C = _random_encoded(n, m, 164, codec, 11, cuda)
    _, _, want = t_assign.apnc_assign(lloyd_step.dequant_decode(Yq, sc), C, disc)
    got = lloyd_step.fused_dequant_step(Yq, sc, C, disc)
    again = lloyd_step.fused_dequant_step(Yq, sc, C, disc)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # bitwise run to run
    assert torch.equal(got[1], torch.bincount(want.long(), minlength=164).float())


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_wide_encoded_block_takes_the_decode_route(cuda, codec):
    """Above DEQUANT_MAX_M the plan decodes with the decode kernel and
    assigns with apnc_assign (its streamed wide-m kernel beyond m = 832)."""
    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.blockstore import EncodedBlock

    n, k, m = 700, 11, lloyd_step.DEQUANT_MAX_M + 100
    Yq, sc, C = _encoded_blob(n, m, k, codec, 5, cuda)
    before = (lloyd_step.launches["dequant_decode"], lloyd_step.launches["fused_dequant_step"],
              t_assign.launches)
    got = ops.lloyd_step_plan(discrepancy="l2").step(EncodedBlock(Yq, sc), C)
    got2 = ops.lloyd_step_plan(discrepancy="l2").step(EncodedBlock(Yq, sc), C)
    torch.cuda.synchronize()
    assert lloyd_step.launches["dequant_decode"] == before[0] + 2
    assert lloyd_step.launches["fused_dequant_step"] == before[1]
    assert t_assign.launches == before[2] + 2
    _check_step(got, ref.fused_dequant_step_ref(Yq, sc, C, "l2"), got2, cost_rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_assign_kernel_wide_m_matches_plain(cuda, disc):
    rng = np.random.default_rng(8)
    Y = torch.from_numpy(rng.standard_normal((1500, 1000)).astype(np.float32)).to(cuda)
    C = torch.from_numpy((rng.standard_normal((70, 1000)) * 2).astype(np.float32)).to(cuda)
    Z, g, labels = ops.apnc_assign(Y, C, disc)
    Z2, g2, labels2 = ops.apnc_assign(Y, C, disc)
    Zr, gr, lr = ref.apnc_assign_ref(Y, C, disc)
    assert torch.equal(labels, lr) and torch.equal(g, gr)
    assert torch.equal(Z, Z2) and torch.equal(labels, labels2)
    torch.testing.assert_close(Z, Zr, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_stream_sweep_on_card_matches_cpu(cuda, codec):
    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.blockstore import BlockStore

    X = gaussian_blobs_blocks(0, 5000, 16, 6, block_rows=1024, separation=4.0)[0].materialize()
    kw = dict(l=128, m=64, kernel_params=dict(gamma=0.01), block_rows=1000, backend="stream",
              policy=ComputePolicy(cache_dtype=codec))
    before = lloyd_step.launches["fused_dequant_step"]
    gpu = KernelKMeans(6, **kw).sweep(BlockStore.from_array(X, 1000), k_grid=[5, 6], restarts=2)
    launched = lloyd_step.launches["fused_dequant_step"] - before
    assert (launched > 0) == (codec != "f32")
    cpu = KernelKMeans(6, device="cpu", **kw).sweep(BlockStore.from_array(X, 1000),
                                                     k_grid=[5, 6], restarts=2)
    for i in range(2):
        for r in range(2):
            assert (gpu.labels[i][r] == cpu.labels[i][r]).mean() >= 0.999
    np.testing.assert_allclose(gpu.inertia, cpu.inertia, rtol=1e-3)


FLASH_SHAPES = [(2, 512, 3, 64), (1, 96, 2, 40), (2, 256, 4, 128), (1, 1000, 2, 128),
                (2, 257, 3, 40), (1, 70, 2, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 50, 4096])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_matches_plain(cuda, shape, window, dtype):
    from repro_torch.kernels import flash_attention as t_flash

    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    if dtype == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = t_flash.launches
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert t_flash.launches == before + 2
    assert got.dtype == q.dtype and torch.equal(got, again)  # bitwise run to run
    want = ref.flash_attention_ref(q, k, v, window)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "f32" else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_views(cuda):
    qkv = torch.randn((2, 300, 3, 4, 64), generator=torch.Generator().manual_seed(12)).to(cuda)
    q, k, v = qkv.unbind(2)
    got = ops.flash_attention(q, k, v, window=0)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=0)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_lm_serve_on_card_matches_cpu(cuda):
    """The serving path on the card (the kernel in every prefill layer) against
    the same model on the CPU (the plain version), reduced qwen1.5-0.5b."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    cfg = reduced(get_arch("qwen1.5-0.5b"))
    cpu_model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
    gpu_model = lm.build(cfg, TEST_POLICY, cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(1, cfg.vocab_size, (3, 70), generator=torch.Generator().manual_seed(1))
    before = t_flash.launches
    on_card = serve.generate(gpu_model, cfg, TEST_POLICY, {"tokens": toks.to(cuda)}, 6)
    assert t_flash.launches == before + cfg.num_layers
    on_cpu = serve.generate(cpu_model, cfg, TEST_POLICY, {"tokens": toks}, 6)
    torch.testing.assert_close(on_card.logits[0].cpu(), on_cpu.logits[0], rtol=1e-4, atol=1e-5)
    for i in range(6):  # equal tokens, up to a step whose top-2 logits nearly tie
        if not torch.equal(on_card.tokens[:, i].cpu(), on_cpu.tokens[:, i]):
            top2 = torch.topk(on_cpu.logits[i], 2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) < 1e-4, i
            break
        torch.testing.assert_close(on_card.logits[i].cpu(), on_cpu.logits[i],
                                   rtol=1e-4, atol=1e-5)


#: (B, S, H, Hkv, Dh), window: a ragged S, grouped KV heads, head dims 40 to
#: 128, windows shorter and longer than S, S past one backward chunk.
FLASH_GRAD_CASES = [((2, 300, 4, 4, 64), 0), ((1, 1000, 8, 2, 128), 0),
                    ((2, 257, 6, 3, 40), 50), ((1, 700, 4, 4, 64), 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window", FLASH_GRAD_CASES,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_flash_function_gradients_match_plain(cuda, shape, window):
    """Under grad mode ``ops.flash_attention`` takes the kernel through its
    autograd.Function: out within the f32 kernel tolerance of autograd
    through the plain version, dq, dk, dv within 1e-4 * max|g| (the same
    f32 arithmetic summed in another order)."""
    from repro_torch.kernels import flash_attention as t_flash

    B, S, H, Hkv, Dh = shape
    g = torch.Generator().manual_seed(13)
    q = torch.randn((B, S, H, Dh), generator=g).to(cuda)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=g).to(cuda) for _ in range(2))
    dout = torch.randn((B, S, H, Dh), generator=g).to(cuda)
    mine = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = t_flash.launches
    out = ops.flash_attention(*mine, window=window)
    assert t_flash.launches == before + 1
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, mine, dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = ref.flash_attention_ref(*plain, window)
    want = torch.autograd.grad(want_out, plain, dout)
    torch.testing.assert_close(out.detach(), want_out.detach(), rtol=2e-4, atol=2e-5)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


@pytest.mark.gpu
def test_flash_wrapper_raises_on_an_input_that_requires_grad(cuda):
    """The launch records no autograd history: under grad mode with an input
    that requires grad the wrapper raises rather than answer without a
    gradient; without grad mode, or with no input requiring grad, it runs."""
    from repro_torch.kernels import flash_attention as t_flash

    g = torch.Generator().manual_seed(14)
    q, k, v = (torch.randn((1, 64, 2, 16), generator=g).to(cuda) for _ in range(3))
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="records no gradient"):
            t_flash.flash_attention_bhsd(*args)
        with torch.no_grad():
            t_flash.flash_attention_bhsd(*args)
    out = t_flash.flash_attention_bhsd(q, k, v)
    assert out.grad_fn is None


@pytest.mark.gpu
def test_train_gradients_on_card_match_cpu(cuda):
    """forward_train and its gradients on the card (the kernel through the
    Function, twice a layer under remat) against the same model on the CPU
    (the plain attention under autograd), reduced qwen1.5-0.5b: the loss
    within rtol 2e-4, each gradient within 2e-3 * max|g| (chip_smoke.py's
    kernel-vs-plain step bounds)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    cfg = reduced(get_arch("qwen1.5-0.5b"))
    cpu_model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
    gpu_model = lm.build(cfg, TEST_POLICY, cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    host = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 0, 2, 96).items()}
    result = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"), ("card", gpu_model, cuda)):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        before = t_flash.launches
        loss, _ = lm.forward_train(model, cfg, TEST_POLICY, {k: v.to(dev) for k, v in host.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
        result[name] = (float(loss.detach()), {n: gr.cpu() for n, gr in zip(params, grads)},
                        t_flash.launches - before)
    assert result["cpu"][2] == 0 and result["card"][2] == 2 * cfg.num_layers
    assert abs(result["card"][0] - result["cpu"][0]) <= 2e-4 * abs(result["cpu"][0])
    for n, want in result["cpu"][1].items():
        got = result["card"][1][n]
        assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max()), n


def _landmark_params(X_pool, l, m, seed):
    """Landmarks drawn from the pool and a random (m, l) R: the equalities
    below hold for any L and R, so no fit is needed (m may exceed l)."""
    rng = np.random.default_rng(seed)
    L = X_pool[rng.choice(X_pool.shape[0], l, replace=False)].contiguous()
    R = torch.from_numpy((rng.standard_normal((m, l)) * l ** -0.5).astype(np.float32))
    return L, R


@pytest.mark.gpu
@pytest.mark.parametrize("dlm", [(77, 70, 24), (900, 500, 256), (130, 300, 512)],
                         ids=lambda s: "d{}-l{}-m{}".format(*s))
@pytest.mark.parametrize("n", [1, 33, 4097])
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k.name)
def test_fused_apnc_step_labels_equal_unfused_chain(cuda, kern, disc, n, dlm):
    """At equal centroids the fused step's labels are bit for bit those of
    apnc_embed_block -> apnc_assign: both run the same fmaf chains."""
    from repro_torch.kernels import lloyd_step

    d, l, m = dlm
    k = 9
    X, lab = _blob_block(max(n, l) + 256, d, k, seed=5, scale=d ** -0.5)
    L, R = _landmark_params(X, l, m, seed=6)
    Xc, Lc, Rc = X[:n].to(cuda), L.to(cuda), R.to(cuda)
    C = _class_means(t_embed.apnc_embed_block(X.to(cuda), Lc, Rc, kern), lab, k)
    Y = t_embed.apnc_embed_block(Xc, Lc, Rc, kern)
    _, _, want = t_assign.apnc_assign(Y, C, disc)
    got = lloyd_step.fused_apnc_step(Xc, Lc, Rc, C, kern, disc)
    again = lloyd_step.fused_apnc_step(Xc, Lc, Rc, C, kern, disc)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # bitwise run to run


def _misaligned(X):
    """A contiguous copy of X whose data starts 4 bytes past a 16-byte
    boundary: the kernels then take their 4-byte copies."""
    buf = torch.empty(X.numel() + 4, dtype=X.dtype, device=X.device)
    Xu = buf[1:1 + X.numel()].view(X.shape)
    Xu.copy_(X)
    assert Xu.data_ptr() % 16 == 4
    return Xu


@pytest.mark.gpu
@pytest.mark.parametrize("dlm", [(900, 500, 256), (132, 300, 512)],
                         ids=lambda s: "d{}-l{}-m{}".format(*s))
def test_fused_apnc_step_copy_widths_agree(cuda, dlm):
    """The 16-byte and 4-byte copy routes give the same bits."""
    from repro_torch.kernels import lloyd_step

    d, l, m = dlm
    X, lab = _blob_block(4097, d, 9, seed=7, scale=d ** -0.5)
    L, R = _landmark_params(X, l, m, seed=8)
    Xc, Lc, Rc = X.to(cuda), L.to(cuda), R.to(cuda)
    kern = KERNELS[0]
    C = _class_means(t_embed.apnc_embed_block(Xc, Lc, Rc, kern), lab, 9)
    got = lloyd_step.fused_apnc_step(Xc, Lc, Rc, C, kern, "l2")
    slow = lloyd_step.fused_apnc_step(_misaligned(Xc), Lc, Rc, C, kern, "l2")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, slow))


def _rff_case(n, d, mh, k, seed):
    X, lab = _blob_block(max(n, 512), d, k, seed=seed, scale=d ** -0.5)
    W = torch.randn((d, mh), generator=torch.Generator().manual_seed(seed)) * 0.5
    return X, lab, W, mh ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dmh", [(77, 65), (900, 128), (130, 12), (900, 256), (902, 256)],
                         ids=lambda s: "d{}-mh{}".format(*s))
@pytest.mark.parametrize("n", [1, 33, 4097, 20_000])
@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_rff_embed_then_assign_equals_fused_rff_step(cuda, disc, n, dmh):
    """rff_embed_block's Y is the Y fused_rff_step builds inside itself: the
    un-fused chain's labels equal the fused step's bit for bit."""
    from repro_torch.kernels import lloyd_step, rff_embed

    d, mh = dmh
    X, lab, W, scale = _rff_case(n, d, mh, 9, seed=9)
    Wc = W.to(cuda)
    C = _class_means(rff_embed.rff_embed_block(X.to(cuda), Wc, scale), lab, 9)
    Xc = X[:n].to(cuda)
    Y = rff_embed.rff_embed_block(Xc, Wc, scale)
    again = rff_embed.rff_embed_block(Xc, Wc, scale)
    _, _, want = t_assign.apnc_assign(Y, C, disc)
    got = lloyd_step.fused_rff_step(Xc, Wc, C, scale, disc)
    torch.cuda.synchronize()
    assert torch.equal(Y, again)  # bitwise run to run
    assert torch.equal(got[2], want)


@pytest.mark.gpu
@pytest.mark.parametrize("dmh", [(77, 65), (900, 128)], ids=lambda s: "d{}-mh{}".format(*s))
def test_rff_embed_rows_do_not_depend_on_the_tiling(cuda, dmh):
    """Each row of Y is its own chain: a slice of the rows embeds to the same
    bits as those rows of the whole, whatever tile they fall in, and the
    16-byte and 4-byte copy routes agree."""
    from repro_torch.kernels import rff_embed

    d, mh = dmh
    X, _, W, scale = _rff_case(4097, d, mh, 9, seed=10)
    Xc, Wc = X.to(cuda), W.to(cuda)
    Y = rff_embed.rff_embed_block(Xc, Wc, scale)
    for i, j in ((0, 1), (3, 70), (33, 4097), (4000, 4097)):
        assert torch.equal(rff_embed.rff_embed_block(Xc[i:j], Wc, scale), Y[i:j])
    assert torch.equal(rff_embed.rff_embed_block(_misaligned(Xc), Wc, scale), Y)


def _embed_case(n, d, l, m, seed):
    """Rows, landmarks drawn from them and a random R, at unit row scale."""
    X, _ = _blob_block(max(n, l), d, 9, seed=seed, scale=d ** -0.5)
    L, R = _landmark_params(X, l, m, seed=seed + 1)
    return X[:n].contiguous(), L, R


@pytest.mark.gpu
@pytest.mark.parametrize("dlm", [(77, 70, 24), (900, 500, 256), (130, 300, 600)],
                         ids=lambda s: "d{}-l{}-m{}".format(*s))
@pytest.mark.parametrize("n", [4097, 40_000])
def test_apnc_embed_rows_do_not_depend_on_the_launch(cuda, n, dlm):
    """X[a:b] embedded alone equals rows a:b of the whole launch bit for bit,
    whichever geometry each launch takes (64-row tiles for a launch of many
    waves, 32-row tiles otherwise), for ragged d, l and m, for m above one
    launch's 512 columns (column groups), and into an out= column slice."""
    d, l, m = dlm
    X, L, R = (t.to(cuda) for t in _embed_case(n, d, l, m, seed=20))
    kern = KERNELS[0]
    Y = t_embed.apnc_embed_block(X, L, R, kern)
    if n == 40_000 and m <= 256:
        assert t_embed.tile_rows(n, m) == 64 and t_embed.tile_rows(4096, m) == 32
    for a, b in ((0, 1), (3, 70), (33, 4097), (n - 100, n)):
        assert torch.equal(t_embed.apnc_embed_block(X[a:b].contiguous(), L, R, kern), Y[a:b])
    wide = torch.full((n, m + 40), 7.0, device=cuda)
    t_embed.apnc_embed_block(X, L, R, kern, out=wide[:, 20:20 + m])
    torch.cuda.synchronize()
    assert torch.equal(wide[:, 20:20 + m], Y)
    assert bool((wide[:, :20] == 7.0).all()) and bool((wide[:, 20 + m:] == 7.0).all())
    want = ref.apnc_embed_ref(X, L[None], R[None], kern)
    torch.testing.assert_close(Y, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("n", [4097, 40_000])
def test_apnc_embed_bf16_x_matches_plain(cuda, kern, n):
    """The bf16-X variant widens X to f32 as it stages it: its result is the
    f32 kernel's on the widened X bit for bit, and the plain version's within
    the f32 tolerance."""
    X, L, R = (t.to(cuda) for t in _embed_case(n, 900, 500, 256, seed=22))
    Xb = X.to(torch.bfloat16)
    before = t_embed.launches
    got = t_embed.apnc_embed_block(Xb, L, R, kern)
    torch.cuda.synchronize()
    assert t_embed.launches == before + 1
    assert torch.equal(got, t_embed.apnc_embed_block(Xb.float(), L, R, kern))
    want = ref.apnc_embed_ref(Xb, L[None], R[None], kern)
    tol = 2e-3 if kern.name == "poly" else 2e-5  # poly amplifies roundoff
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 50, 4096])
@pytest.mark.parametrize("head_dim", [33, 40, 64, 128, 200, 256])
@pytest.mark.parametrize("groups", [1, 2, 4], ids=lambda g: f"hkv=h/{g}")
def test_flash_attention_grouped_heads_on_strided_views(cuda, groups, head_dim, window, dtype):
    """Grouped KV heads read by head index in the kernel (k, v with H / groups
    heads), q, k and v as head slices of one fused tensor: within the
    reference's tolerance of the plain version on repeated k and v, bitwise
    run to run and bitwise the result on contiguous copies."""
    from repro_torch.kernels import flash_attention as t_flash

    B, S, H = 2, 300, 4
    hkv = H // groups
    g = torch.Generator().manual_seed(31)
    qkv = torch.randn((B, S, H + 2 * hkv, head_dim), generator=g).to(cuda)
    if dtype == "bf16":
        qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + hkv], qkv[:, :, H + hkv:]
    before = t_flash.launches
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    dense = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=window)
    torch.cuda.synchronize()
    assert t_flash.launches == before + 3
    assert got.dtype == q.dtype and torch.equal(got, again) and torch.equal(got, dense)
    rep = (k.repeat_interleave(groups, dim=2), v.repeat_interleave(groups, dim=2))
    want = ref.flash_attention_ref(q, *rep, window)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "f32" else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_plain_bf16_route_on_the_card_launches_nothing(cuda):
    """ComputePolicy(kernels=False, precision="bf16") on the card: the plain
    version in bf16 (the embed and the un-fused plan), no kernel launch, and
    the CPU's bf16 transform within the bf16 tolerance."""
    from repro_torch import embed
    from repro_torch.kernels import lloyd_step
    from repro_torch.policy import ComputePolicy

    X = torch.from_numpy(np.random.default_rng(4).standard_normal((1003, 77)).astype(np.float32))
    params = fit_nystrom(1, X, KERNELS[0], l=100, m=33)
    pol = ComputePolicy(kernels=False, precision="bf16")
    counts = (t_embed.launches, t_assign.launches, dict(lloyd_step.launches))
    got = embed.transform(params.to(cuda), X.to(cuda), pol)
    plan = ops.lloyd_step_plan(params.to(cuda), policy=pol)
    assert not plan.fused
    plan.step(X.to(cuda), got[:5].clone())
    torch.cuda.synchronize()
    assert (t_embed.launches, t_assign.launches, dict(lloyd_step.launches)) == counts
    want = embed.transform(params, X, pol)
    assert not torch.equal(want, embed.transform(params, X))  # bf16, not f32
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2 * float(want.abs().max()))


@pytest.mark.gpu
def test_member_without_a_kernel_takes_its_plain_route_on_the_card(cuda, monkeypatch):
    """A registered member whose kernel_transform returns None is served by
    its plain version on the card, as the JAX package does without a Pallas
    kernel; nothing is launched."""
    import dataclasses

    from repro_torch import embed
    from repro_torch.embed import base

    @dataclasses.dataclass
    class HalvedParams:
        scale: torch.Tensor
        m: int = 8
        d: int = 8
        discrepancy: str = "l2"

    class Halving(base.Embedding):
        name = "halving-test-double"
        params_cls = HalvedParams

        def fit(self, seed, data, kernel, *, l, m, t=None, q=1):
            return HalvedParams(torch.tensor(0.5, device=data.device))

        def transform(self, params, X):
            return X * params.scale

        def props(self, params):
            return base.EmbeddingProps(linear=True, discrepancy="l2")

    monkeypatch.setitem(base.EMBEDDINGS, Halving.name, Halving())
    monkeypatch.setitem(base._BY_PARAMS, HalvedParams, base.EMBEDDINGS[Halving.name])
    X = torch.randn((64, 8), generator=torch.Generator().manual_seed(5)).to(cuda)
    before = t_embed.launches
    got = embed.transform(HalvedParams(torch.tensor(0.5, device=cuda)), X)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, X * 0.5) and t_embed.launches == before


def _same_bits(got, want):
    for name, a, b in zip(("Z", "g", "labels", "cost"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 33, 4096, 4097, 40_000])
@pytest.mark.parametrize("disc", ["l2", "l1"])
def test_assign_step_equals_the_fused_steps_bitwise(cuda, disc, n):
    """apnc_assign_step on the Y each fused step's un-fused chain makes gives
    that fused step's (Z, g, labels, cost) bit for bit: the same epilogue,
    32-row tiles, CTAs and reduction order. Centroids are other rows'
    embeddings, so rows sit near several; n = 40,000 puts several tiles on a
    CTA. Two launches are bitwise equal."""
    from repro_torch.kernels import lloyd_step, rff_embed

    d, l, m, k = 900, 500, 256, 164
    X, _ = _blob_block(max(n, l) + k, d, 9, seed=41, scale=d ** -0.5)
    L, R = _landmark_params(X, l, m, seed=42)
    Xc, Lc, Rc = X[:n].to(cuda), L.to(cuda), R.to(cuda)
    kern = KERNELS[0]
    C = t_embed.apnc_embed_block(X[-k:].to(cuda), Lc, Rc, kern)
    Y = t_embed.apnc_embed_block(Xc, Lc, Rc, kern)
    got = t_assign.apnc_assign_step(Y, C, disc)
    _same_bits(t_assign.apnc_assign_step(Y, C, disc), got)
    _same_bits(got, lloyd_step.fused_apnc_step(Xc, Lc, Rc, C, kern, disc))

    W = (torch.randn((d, m // 2), generator=torch.Generator().manual_seed(43)) * 0.5).to(cuda)
    scale = (m // 2) ** -0.5
    Cr = rff_embed.rff_embed_block(X[-k:].to(cuda), W, scale)
    _same_bits(t_assign.apnc_assign_step(rff_embed.rff_embed_block(Xc, W, scale), Cr, disc),
               lloyd_step.fused_rff_step(Xc, W, Cr, scale, disc))

    for codec in ("int8", "bf16"):
        Yq, sc, Cq = _random_encoded(n, m, k, codec, 44, cuda)
        _same_bits(t_assign.apnc_assign_step(lloyd_step.dequant_decode(Yq, sc), Cq, disc),
                   lloyd_step.fused_dequant_step(Yq, sc, Cq, disc))


@pytest.mark.gpu
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nkm", [(4096, 164, 256), (4097, 67, 70), (40_000, 164, 256),
                                 (517, 13, 832), (1500, 70, 1000)],
                         ids=lambda s: "n{}-k{}-m{}".format(*s))
def test_assign_step_matches_plain(cuda, disc, nkm):
    """The step against its plain version on separated blobs: labels and g
    equal, Z within rtol 1e-4, the cost within rtol 1e-4; m = 832 is the
    tiled kernel's widest, m = 1,000 the streamed kernel's. One launch a
    call."""
    n, k, m = nkm
    Y, lab = _blob_block(n, m, k, seed=45, scale=m ** -0.5)
    Yc = Y.to(cuda)
    C = _class_means(Yc, lab, k)
    before = t_assign.launches
    got = t_assign.apnc_assign_step(Yc, C, disc)
    got2 = t_assign.apnc_assign_step(Yc, C, disc)
    torch.cuda.synchronize()
    assert t_assign.launches == before + 2
    _check_step(got, ref.apnc_assign_step_ref(Yc, C, disc), got2, cost_rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [256, 1000])
def test_y_mode_step_is_one_assign_launch_and_no_gemm(cuda, m):
    """On the card the Y-mode step makes one apnc_assign launch and its
    reduce, and no GEMM: the cost comes out of the assign launch, where the
    plain route computes block_cost's distance matrix."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    Y, lab = _blob_block(5000, m, 11, seed=46, scale=m ** -0.5)
    Yc = Y.to(cuda)
    C = _class_means(Yc, lab, 11)
    plan = ops.lloyd_step_plan(discrepancy="l2")
    plan.step(Yc, C)
    torch.cuda.synchronize()
    before = t_assign.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = plan.step(Yc, C)
        torch.cuda.synchronize()
    assert t_assign.launches == before + 1
    kernels = [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    assert not [name for name in kernels if "gemm" in name.lower()], kernels
    assert sum("assign" in name for name in kernels) == 1, kernels
    assert sum("lloyd_reduce_kernel" in name for name in kernels) == 1, kernels
    want = ref.apnc_assign_step_ref(Yc, C, "l2")
    _check_step(got, want, plan.step(Yc, C), cost_rtol=1e-4)


# ------------------------------------------------- checkpoints on the card


def _failing(store, fail_after):
    """``store`` behind a get() that raises once ``fail_after`` reads have
    been served (the engine's producer thread makes them)."""
    import threading

    from repro_torch.stream.blockstore import BlockStore

    count, lock = [0], threading.Lock()

    def get(i):
        with lock:
            count[0] += 1
            if count[0] > fail_after:
                raise RuntimeError("injected ingest crash")
        return store.get(i)

    return BlockStore(get, n=store.n, d=store.d, block_rows=store.block_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["nystrom", "rff"])
def test_save_and_load_on_the_card_predict_bitwise(cuda, tmp_path, method):
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X = gaussian_blobs_blocks(0, 3000, 16, 6, block_rows=1024, separation=4.0)[0].materialize()
    est = KernelKMeans(6, method=method, l=128, m=64, kernel_params=dict(gamma=0.01)).fit(X)
    est.save(tmp_path)
    loaded = KernelKMeans.load(tmp_path)
    assert loaded.model_.centroids.device.type == "cuda"
    assert torch.equal(loaded.model_.centroids, est.model_.centroids)
    np.testing.assert_array_equal(loaded.predict(X), est.predict(X))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["stream", "minibatch"])
def test_stream_fit_crashed_and_resumed_on_the_card_is_bitwise(cuda, tmp_path, backend):
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.blockstore import BlockStore

    X = gaussian_blobs_blocks(0, 6000, 16, 6, block_rows=1024, separation=2.0)[0].materialize()
    store = BlockStore.from_array(X, 500)
    nb = store.num_blocks

    def make():
        return KernelKMeans(6, l=128, m=64, kernel_params=dict(gamma=0.01), block_rows=500,
                            backend=backend, epochs=3, iters=10)

    before = lloyd_step.launches["fused_apnc_step"]
    ref = make().fit(store, seed=2)
    assert lloyd_step.launches["fused_apnc_step"] > before
    with pytest.raises(RuntimeError, match="injected ingest crash"):
        make().fit(_failing(store, 2 * nb + nb // 2), seed=2, checkpoint_dir=tmp_path)
    assert ckpt.latest_step(tmp_path / "restart_0" / ckpt.LLOYD_STATE_DIR) >= 1
    ckpt.reset_counters()
    resumed = make().fit(store, seed=2, checkpoint_dir=tmp_path)
    assert ckpt.COUNTERS["ckpt_resumes"] == 1
    np.testing.assert_array_equal(resumed.labels_, ref.labels_)
    assert (resumed.n_iter_, resumed.inertia_) == (ref.n_iter_, ref.inertia_)
    assert torch.equal(resumed.model_.centroids, ref.model_.centroids)


@pytest.mark.gpu
def test_partial_fit_kernel_route_matches_plain_at_equal_state(cuda, tmp_path):
    """Both routes warm-started from one saved model and given one block:
    each call one apnc_embed and one apnc_assign launch on the default route,
    none on the plain one; the same labels (well-separated blobs: no near
    ties), g equal, Z and the centroids within rtol 1e-4, atol 1e-4 of the
    largest |value|."""
    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X = gaussian_blobs_blocks(0, 4096, 16, 6, block_rows=1024, separation=4.0)[0].materialize()
    KernelKMeans(6, l=128, m=64, kernel_params=dict(gamma=0.01)).fit(X[:3000]).save(tmp_path)
    kern = KernelKMeans.load(tmp_path)
    plain = KernelKMeans.load(tmp_path, policy=ComputePolicy(kernels=False))
    block = X[3000:]
    before = (t_embed.launches, t_assign.launches)
    kern.partial_fit(block)
    torch.cuda.synchronize()
    assert (t_embed.launches, t_assign.launches) == (before[0] + 1, before[1] + 1)
    plain.partial_fit(block)
    assert (t_embed.launches, t_assign.launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(kern.labels_, plain.labels_)
    (Zk, gk, rk), (Zp, gp, rp) = kern._pf_state, plain._pf_state
    assert rk == rp and torch.equal(gk, gp)
    torch.testing.assert_close(Zk, Zp, rtol=1e-4, atol=1e-4 * float(Zp.abs().max()))
    Cp = plain.model_.centroids
    torch.testing.assert_close(kern.model_.centroids, Cp, rtol=1e-4,
                               atol=1e-4 * float(Cp.abs().max()))


BASELINES = ["exact_kernel_kmeans", "rff_kmeans", "svd_rff_kmeans", "two_stage"]


def _imagenet_4000(cuda):
    from repro_torch.core.kernels_fn import self_tuned_rbf
    from repro_torch.data.synthetic import paper_standin

    X, _, ds = paper_standin("imagenet-50k", 0, n_override=4_000, device=cuda)
    return X, self_tuned_rbf(X, seed=0), ds.k


@pytest.mark.gpu
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_on_the_card_equals_the_cpu(cuda, name):
    """The paper's baselines at n = 4,000 of the imagenet-50k stand-in
    (d = 900, k = 164), on the card and on a CPU copy from the same seed (the
    draws are the CPU generator's either way): labels equal outside near
    ties under the CPU run's distances, the objective within rtol 1e-4.
    approx_kkm is held step by step (the next test)."""
    from repro_torch.core import baselines as B

    X, kern, k = _imagenet_4000(cuda)
    run = dict(
        exact_kernel_kmeans=lambda Xr: B.exact_kernel_kmeans(0, kern.gram(Xr, Xr), kern.diag(Xr),
                                                             k),
        rff_kmeans=lambda Xr: B.rff_kmeans(0, Xr, kern.gamma, k, 128),
        svd_rff_kmeans=lambda Xr: B.svd_rff_kmeans(0, Xr, kern.gamma, k, 128),
        two_stage=lambda Xr: B.two_stage(0, Xr, kern, k, 500))[name]
    a, b = run(X), run(X.cpu())
    assert a.labels.device.type == "cuda" and a.labels.dtype == torch.int32
    lab_a, lab_b = a.labels.cpu().long(), b.labels.long()
    rows = torch.nonzero(lab_a != lab_b).flatten()
    assert rows.numel() <= 4
    if rows.numel():
        d2 = B._final_d2(name, 0, X.cpu(), kern, k, l=500, m=128)[rows]
        gap = (d2.gather(1, lab_a[rows, None]) - d2.gather(1, lab_b[rows, None])).abs()[:, 0]
        assert bool((gap <= 1e-4 * d2.abs().max(dim=1).values).all())
    np.testing.assert_allclose(float(a.objective), float(b.objective), rtol=1e-4)


@pytest.mark.gpu
def test_approx_kkm_steps_on_the_card_equal_the_cpu(cuda):
    """approx_kkm's pseudo-inverse cutoff sits inside the rbf K_LL's
    spectrum, so roundoff is amplified and a free run's near tie spreads:
    its 20 steps are held on the card against the CPU from the same labels
    at every step, distances within 1e-3 of the largest and every differing
    argmin a tie within twice the row's card-vs-CPU difference."""
    from repro_torch.core import baselines as B

    X, kern, k = _imagenet_4000(cuda)
    card, cpu = B._approx_inputs(0, X, kern, k, 500), B._approx_inputs(0, X.cpu(), kern, k, 500)
    labels = cpu[4]
    for _ in range(20):
        d2_card = B._approx_d2(*card[:4], labels.to(cuda), k).cpu()
        d2_cpu = B._approx_d2(*cpu[:4], labels, k)
        diff = (d2_card - d2_cpu).abs()
        assert float(diff.max() / d2_cpu.abs().max()) <= 1e-3
        lab_card, labels = torch.argmin(d2_card, dim=-1), torch.argmin(d2_cpu, dim=-1)
        rows = torch.nonzero(lab_card != labels).flatten()
        gap = (d2_cpu[rows, lab_card[rows]] - d2_cpu[rows, labels[rows]]).abs()
        assert bool((gap <= 2 * diff[rows].max(dim=1).values).all())


@pytest.mark.gpu
def test_rbf_gram_in_place_on_the_card(cuda):
    """The 50,000-row Gram's path at 12,000 rows: the bits of the
    out-of-place expression, with no second (n, n) buffer beside the output."""
    X = torch.randn((12_000, 900), device=cuda) * 0.5
    kern = Kernel("rbf", gamma=1e-3)
    xx = torch.sum(X * X, dim=-1, keepdim=True)
    want = torch.exp(-1e-3 * torch.clamp(xx - 2.0 * (X @ X.T) + xx.T, min=0.0))
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = kern.gram(X, X)
    torch.cuda.synchronize()
    out_bytes = got.numel() * 4
    assert torch.cuda.max_memory_allocated() - start < 1.05 * out_bytes
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_traced_stream_fit_on_the_card(cuda, tmp_path):
    """A traced stream fit over a pinned store: the lanes main and
    producer:cuda:<i>, one h2d span a block a pass, the phase spans; the
    report's blocks all on that card; one engine.fused_dispatches a
    fused_apnc_step launch; the labels those of the untraced fit."""
    import json

    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.blockstore import BlockStore

    X = gaussian_blobs_blocks(0, 40_000, 64, 8, block_rows=4096, separation=3.0)[0].materialize()
    host = torch.from_numpy(X).pin_memory()
    store = BlockStore.from_array(host.numpy(), 4096)
    make = lambda: KernelKMeans(8, l=128, m=64, backend="stream", iters=6,  # noqa: E731
                                kernel_params=dict(gamma=0.01))
    plain = make().fit(store, seed=1)
    obs.clear_trace()
    obs.enable_tracing()
    before_launch = lloyd_step.launches["fused_apnc_step"]
    before = obs.snapshot("engine.")
    try:
        est = make().fit(store, seed=1)
    finally:
        obs.disable_tracing()
    d = obs.delta(before, obs.snapshot("engine."))
    r = est.fit_report_
    lane = f"cuda:{torch.cuda.current_device()}"
    passes = sum(r.pass_counts.values())
    assert r.per_device_blocks == {lane: store.num_blocks * passes} == {lane: r.blocks_read}
    assert r.bytes_h2d == passes * X.nbytes
    assert d["engine.fused_dispatches"] == (lloyd_step.launches["fused_apnc_step"]
                                            - before_launch) == r.blocks_read
    events = json.loads(obs.write_trace(tmp_path / "t.json").read_text())["traceEvents"]
    obs.clear_trace()
    assert sorted(e["args"]["name"] for e in events if e["ph"] == "M") == [
        "main", f"producer:{lane}"]
    names = [e["name"] for e in events if e["ph"] == "X"]
    assert names.count("h2d") == store.num_blocks * passes
    assert all(names.count(f"phase.{p}") == 1 for p in ("reservoir", "embed_fit", "seed", "lloyd"))
    np.testing.assert_array_equal(est.labels_, plain.labels_)


@pytest.mark.gpu
def test_traced_predict_spans_each_launch_on_the_card(cuda):
    """A traced predict on the card: one launch.apnc_embed and one
    launch.apnc_assign span for each launch the wrappers count, each inside
    a predict span and with the batch's rows (the assign's also with its
    discrepancy); the labels those of an untraced call."""
    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X = gaussian_blobs_blocks(0, 8000, 64, 8, block_rows=4096, separation=3.0)[0].materialize()
    est = KernelKMeans(8, l=128, m=64, iters=3, kernel_params=dict(gamma=0.01)).fit(X)
    batch = torch.from_numpy(X[:3000]).to(cuda)
    want = est.predict(batch)
    before = {t_embed: t_embed.launches, t_assign: t_assign.launches}
    obs.clear_trace()
    obs.enable_tracing()
    try:
        got = [est.predict(batch) for _ in range(3)]
    finally:
        obs.disable_tracing()
    spans = obs.TRACER.spans()
    obs.clear_trace()
    calls = [(s.t0, s.t0 + s.dur) for s in spans if s.name == "predict"]
    assert len(calls) == 3
    for module, name, attrs in (
            (t_embed, "launch.apnc_embed", {"rows": 3000}),
            (t_assign, "launch.apnc_assign", {"rows": 3000, "discrepancy": "l2"})):
        launches = [s for s in spans if s.name == name]
        assert len(launches) == module.launches - before[module] == 3
        assert all(s.attrs == attrs for s in launches)
        assert all(any(a <= s.t0 and s.t0 + s.dur <= b for a, b in calls) for s in launches)
    for labels in got:
        np.testing.assert_array_equal(labels, want)


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def served_models():
    """A Nystrom and an rff model at the paper's ImageNet width (d = 900,
    k = 164; l = 500, m = 256 and m/2 = 128) fitted on the card, and 10,000
    held-out rows of their mixture on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs

    X, _ = gaussian_blobs(0, 40_000, 900, 164, separation=1.5)
    fit = lambda **kw: KernelKMeans(164, kernel="rbf", iters=5, backend="local",  # noqa: E731
                                    **kw).fit(X[:30_000]).model_
    return dict(nystrom=fit(l=500, m=256), rff=fit(method="rff", m=128)), X[30_000:].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nystrom", "rff"])
def test_served_labels_equal_predict_on_the_card(cuda, served_models, name):
    """make_process_fn's 256-row micro-batches (the last one padded) give
    core.kkmeans.predict's labels over all 10,000 rows, exactly, with one
    embedding launch and one apnc_assign launch a micro-batch."""
    from repro_torch.core.kkmeans import predict
    from repro_torch.kernels import rff_embed as t_rff
    from repro_torch.serving import make_process_fn

    models, Xq = served_models
    model = models[name]
    embed_mod = t_embed if name == "nystrom" else t_rff
    process = make_process_fn(model, max_batch=256)
    before = (embed_mod.launches, t_assign.launches)
    served = np.concatenate([process(Xq[lo:lo + 256]) for lo in range(0, len(Xq), 256)])
    flushes = -(-len(Xq) // 256)
    assert (embed_mod.launches - before[0], t_assign.launches - before[1]) == (flushes, flushes)
    want = predict(Xq, model.params, model.centroids).cpu().numpy()
    np.testing.assert_array_equal(served, want)
    assert served.dtype == np.int32 and len(np.unique(want)) > 100


@pytest.mark.gpu
def test_swap_under_load_on_the_card(cuda, served_models):
    """An open-loop run hot-swapped from the Nystrom to the rff model: every
    admitted request answered, both versions served, each label its
    version's predict; the two threads' launches all counted."""
    from repro_torch.core.kkmeans import predict
    from repro_torch.kernels import rff_embed as t_rff
    from repro_torch.serving import ModelRegistry, ServingTier, run_open_loop

    models, Xq = served_models
    refs = {1: predict(Xq, models["nystrom"].params, models["nystrom"].centroids),
            2: predict(Xq, models["rff"].params, models["rff"].centroids)}
    refs = {v: r.cpu().numpy() for v, r in refs.items()}
    registry = ModelRegistry(max_batch=256)
    registry.register("default", models["nystrom"])
    before = (t_embed.launches, t_rff.launches, t_assign.launches)
    tier = ServingTier(registry, max_inflight=4096).start()
    try:
        rep = run_open_loop(tier, Xq, qps=5000, n_requests=6000, seed=0, swap_after=2000,
                            swap_source=models["rff"])
    finally:
        tier.stop()
    assert rep.errors == 0 and len(rep.responses) == rep.admitted
    assert rep.admitted + rep.shed == rep.offered and set(rep.by_version) == {1, 2}
    for r in rep.responses:
        assert r.label == refs[r.version][r.request_id % len(Xq)], r
    embeds = (t_embed.launches - before[0]) + (t_rff.launches - before[1])
    assert embeds == t_assign.launches - before[2]  # one of each a flush, the warm included
    assert t_rff.launches - before[1] >= 2


@pytest.mark.gpu
def test_launch_counts_from_two_threads_on_the_card(cuda, served_models):
    """Two threads serving through their own closures at once: every launch
    counted, and each thread's labels its model's."""
    import threading

    from repro_torch.kernels import rff_embed as t_rff
    from repro_torch.serving import make_process_fn

    models, Xq = served_models
    rows = Xq[:256]
    procs = {name: make_process_fn(m, max_batch=256) for name, m in models.items()}
    want = {name: p(rows) for name, p in procs.items()}
    before = (t_embed.launches, t_rff.launches, t_assign.launches)
    calls, bad = 200, []

    def serve(name):
        for _ in range(calls):
            if not np.array_equal(procs[name](rows), want[name]):
                bad.append(name)

    threads = [threading.Thread(target=serve, args=(name,)) for name in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    assert (t_embed.launches - before[0], t_rff.launches - before[1],
            t_assign.launches - before[2]) == (calls, calls, 2 * calls)


# ------------------------------------------------------- the sharded stream


@pytest.fixture(scope="module")
def shard_state():
    """Blobs in a pinned-free host store, Nystrom params and centroids on the
    card: the sharded stream's inputs."""
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.stream import BlockStore

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    gen, _ = gaussian_blobs_blocks(0, 24_000, 48, 9, block_rows=1024, separation=4.0)
    store = BlockStore.from_array(gen.materialize(), 1024)
    X = torch.from_numpy(store.materialize())
    params = fit_nystrom(1, X[:2000], Kernel("rbf", gamma=0.02), l=96, m=40).to("cuda")
    C = ops.embed_block_map(X[:9].cuda(), params).contiguous()
    return store, params, C


@pytest.mark.gpu
def test_two_logical_shards_bitwise_the_single_device_pass(cuda, shard_state):
    """Two logical shards of one card, each on its own thread and stream, at
    equal centroids: every block's (Z, g, labels, cost) is bitwise the
    single-device pass's, so the labels and g are equal and the summed Z and
    cost differ only by the order of the block sums, within 2 (B - 1) u
    sum_b |partial_b| (u = 2^-24)."""
    from repro_torch.stream.engine import map_reduce
    from repro_torch.stream.sharded import cross_device_sum, sharded_map_reduce

    store, params, C = shard_state
    fn = ops.lloyd_step_plan(params=params).block_map([C])
    blocks: dict = {}

    def keep(key):
        def emit(i, out):
            blocks[key, i] = [t.clone() for t in out]
        return emit

    def combine(acc, out):
        return acc[0] + out[0], acc[1] + out[1], acc[2] + out[3], acc[3] + out[0].abs()

    def zeros():
        k, m = C.shape
        return (torch.zeros((k, m), device=cuda), torch.zeros((k,), device=cuda),
                torch.zeros((), device=cuda), torch.zeros((k, m), device=cuda))

    Z1, g1, c1, absZ = map_reduce(store, fn, combine, zeros(), emit=keep("one"), device=cuda)
    devices = [torch.device("cuda", 0)] * 2
    shards = [store.shard(d, 2) for d in range(2)]
    accs = sharded_map_reduce(shards, [fn, fn], combine, [zeros(), zeros()], devices=devices,
                              emits=[keep(("two", d)) for d in range(2)])
    Z2, g2, c2, _ = cross_device_sum(accs, devices)
    torch.cuda.synchronize()
    for d, shard in enumerate(shards):
        for i in range(shard.num_blocks):
            gid = shard.block_id(i)
            for a, b in zip(blocks["one", gid], blocks[("two", d), i]):
                assert torch.equal(a, b), (d, i)
    assert torch.equal(g1, g2)
    B = store.num_blocks
    assert bool(((Z1 - Z2).abs() <= 2 * (B - 1) * 2.0 ** -24 * absZ).all())
    assert abs(float(c1) - float(c2)) <= 2 * (B - 1) * 2.0 ** -24 * abs(float(c1)) * 1.0001


@pytest.mark.gpu
def test_chaos_pool_fit_bitwise_the_fault_free_pool_fit_on_the_card(cuda, shard_state):
    """The pool over two logical shards of one card: a run whose worker 1
    dies after 5 blocks and whose worker 0 sleeps 1 ms a block returns the
    fault-free run's labels, centroids, inertia and trajectory bit for bit,
    and the lockstep run's labels."""
    from repro_torch.pool import ChaosPlan, inject
    from repro_torch.stream import ooc_lloyd

    store, params, C = shard_state
    devices = [torch.device("cuda", 0)] * 2
    common = dict(coeffs=params, init=C, iters=8, devices=devices)
    free = ooc_lloyd(store, 9, scheduler="pool", **common)
    with inject(ChaosPlan().kill(1, after_blocks=5).delay(0, 0.001)):
        chaos = ooc_lloyd(store, 9, scheduler="pool", **common)
    assert np.array_equal(chaos.labels, free.labels)
    assert torch.equal(chaos.centroids, free.centroids)
    assert chaos.inertia == free.inertia and chaos.trajectory == free.trajectory
    lock = ooc_lloyd(store, 9, **common)
    assert np.array_equal(lock.labels, free.labels)


@pytest.mark.gpu
def test_fused_steps_from_two_threads_on_two_streams(cuda, shard_state):
    """Two threads, each on its own stream, launching fused_apnc_step at once:
    each stream gets its own per-stream scratch (`lloyd_step._SCRATCH`), and
    every launch's outputs are bitwise the sequential launch's."""
    import threading

    from repro_torch.kernels import lloyd_step
    from repro_torch.stream.sharded import shard_stream

    store, params, C = shard_state
    Xs = [torch.from_numpy(store.get(i)).cuda() for i in range(4)]
    want = [ops.fused_lloyd_step(x, params, C) for x in Xs]
    got: dict = {}

    def run(d):
        with torch.cuda.stream(shard_stream(torch.device("cuda", 0), d)):
            for rep in range(20):
                for i in range(d, 4, 2):
                    got[d, rep, i] = ops.fused_lloyd_step(Xs[i], params, C)
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=run, args=(d,)) for d in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(got) == 80
    for (d, rep, i), out in got.items():
        for a, b in zip(out, want[i]):
            assert torch.equal(a, b), (d, rep, i)
    streams = {key[1] for key in lloyd_step._SCRATCH}
    assert len(streams) >= 3  # the default stream's and one a shard stream


@pytest.mark.gpu
def test_fused_steps_from_two_threads_on_one_stream(cuda, shard_state):
    """Two threads on ONE stream, each launching fused_apnc_step under its own
    centroids 1,000 times a block: every launch's outputs are bitwise the
    sequential launch's. A launch is two kernels on the stream (the main
    kernel writes per-CTA partials into the stream's one scratch buffer, the
    reduce kernel sums them); without the scratch lock
    (`lloyd_step.step_launch`) the order A.main, B.main, A.reduce sums B's
    partials into A's (Z, g, cost) while A's labels stay right."""
    import threading

    store, params, C = shard_state
    Xs = [torch.from_numpy(store.get(i)[:256]).cuda() for i in range(4)]
    Cs = [C, (1.5 * C).contiguous()]
    want = [[ops.fused_lloyd_step(x, params, c) for x in Xs] for c in Cs]
    for i in range(4):  # a mixed-up pair of launches would show
        assert not torch.equal(want[0][i][0], want[1][i][0])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    got: dict = {}
    start = threading.Barrier(2)

    def run(d):
        with torch.cuda.stream(stream):
            start.wait()
            for rep in range(1000):
                for i in range(4):
                    got[d, rep, i] = ops.fused_lloyd_step(Xs[i], params, Cs[d])
        stream.synchronize()

    threads = [threading.Thread(target=run, args=(d,)) for d in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and len(got) == 8000
    bad = [key for key, out in got.items()
           if not all(torch.equal(a, b) for a, b in zip(out, want[key[0]][key[2]]))]
    assert not bad, f"{len(bad)} of 8000 launches differ, first {bad[:5]}"


@pytest.mark.gpu
def test_mesh_train_on_logical_shards_matches_the_cpu_mesh(cuda):
    """forward_train and its gradients over a (2, 2) mesh of logical shards
    of the card (each shard's attention in the kernel, through the Function
    under remat: two launches a layer a shard) against the same mesh of CPU
    shards (the plain attention), reduced qwen1.5-0.5b: the loss within
    rtol 2e-4, each gradient within 2e-3 * max|g| (the card-vs-CPU bars of
    test_train_gradients_on_card_match_cpu)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.distributed import parallel
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    cfg = reduced(get_arch("qwen1.5-0.5b"))
    model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
    host = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 0, 4, 96).items()}
    result = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        p = parallel.shard_model(make_host_mesh(2, 2, dev), model)
        leaves = p.leaves()
        for t in leaves.values():
            t.requires_grad_(True)
        before = t_flash.launches
        loss, _ = parallel.forward_train(p, TEST_POLICY, {k: v.to(dev) for k, v in host.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        g = {n: sh.gather("cpu") for n, sh in p.unflat(dict(zip(leaves, grads))).items()}
        result[name] = (float(loss.detach()), g, t_flash.launches - before)
    assert result["cpu"][2] == 0 and result["card"][2] == 2 * cfg.num_layers * 4
    assert abs(result["card"][0] - result["cpu"][0]) <= 2e-4 * abs(result["cpu"][0])
    for n, want in result["cpu"][1].items():
        got = result["card"][1][n]
        assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max()), n


@pytest.mark.gpu
def test_mesh_generate_on_logical_shards_matches_the_cpu_mesh(cuda):
    """``serve.generate`` over a (1, 2) mesh of logical shards of the card:
    one kernel launch a layer a model shard in the prefill, none in decode;
    the logits within lm_serve's card-vs-CPU bar of the CPU mesh's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed import parallel
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    cfg = reduced(get_arch("qwen3-4b"))
    model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, device="cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(1))
    on_cpu = serve.generate(parallel.shard_model(make_host_mesh(1, 2), model), cfg, TEST_POLICY,
                            {"tokens": toks}, 4)
    before = t_flash.launches
    on_card = serve.generate(parallel.shard_model(make_host_mesh(1, 2, cuda), model), cfg,
                             TEST_POLICY, {"tokens": toks.to(cuda)}, 4)
    assert t_flash.launches == before + 2 * cfg.num_layers
    torch.testing.assert_close(on_card.logits[0].cpu(), on_cpu.logits[0], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_jamba_mesh_prefill_on_logical_shards_matches_one_device(cuda, shape):
    """Reduced jamba (Mamba layers split over d_inner with their mid-layer
    x_proj sum, an attention layer, MoE FFNs) prefilled on a mesh of logical
    shards of the card against one device on the card, f32: one kernel
    launch an attention layer a coordinate; the logits within lm_mesh (b)'s
    bar, 1e-4 * max|logits|. Each data shard holds (4 / D) x 128 tokens, a
    whole number of the MoE's 256-token routing groups, so it routes as one
    device does."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed import parallel
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    cfg = dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")), remat="none")
    model = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg, TEST_POLICY, cuda)
    toks = torch.randint(1, cfg.vocab_size, (4, 128), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks.to(cuda)}
    with torch.inference_mode():
        want, _ = lm.forward_prefill(model, cfg, TEST_POLICY, batch)
        p = parallel.shard_model(make_host_mesh(*shape, cuda), model)
        before = t_flash.launches
        got, _ = parallel.forward_prefill(p, TEST_POLICY, batch)
    attn = sum(s.mixer == "attn" for s in cfg.layer_pattern()) * cfg.num_groups
    assert t_flash.launches == before + attn * shape[0] * shape[1]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
def test_dryrun_meta_count_equals_the_card(cuda):
    """The dry-run's count of a train step on a (1, 2) mesh of meta devices
    against the same step on logical shards of the card: every coordinate's
    parameter and optimizer bytes from the specs equal its blocks on the
    card, and the GEMM flops equal FlopCounterMode's on the card (the
    attention forward is the kernel's launch there, its counted op on meta;
    its backward the same recompute on both)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.distributed import parallel
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim.adamw import AdamWConfig

    cfg = reduced(get_arch("qwen1.5-0.5b"))
    opt_cfg = AdamWConfig()
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 0, 4, 128).items()}
    meta = make_mesh((1, 2), ("data", "model"), devices=["meta"] * 2)
    p = parallel.shard_model(meta, lm.build(cfg, TEST_POLICY, device="meta"))
    counted = dryrun.count(dryrun.prepare_step(cfg, TEST_POLICY, opt_cfg, p, "train",
                                               {k: v.to("meta") for k, v in batch.items()}))
    param, opt = dryrun.state_bytes(cfg, TEST_POLICY, opt_cfg, meta)
    model = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg, TEST_POLICY, cuda)
    p = parallel.shard_model(make_mesh((1, 2), ("data", "model"), devices=[cuda] * 2), model)
    state = dryrun.opt_state_like(p, opt_cfg)
    for at in ((0, 0), (0, 1)):
        assert dryrun.block_bytes(p.params, at) == param
        assert 4 + dryrun.block_bytes(state.mu, at) + dryrun.block_bytes(state.nu, at) == opt
    step = dryrun.prepare_step(cfg, TEST_POLICY, opt_cfg, p, "train",
                               {k: v.to(cuda) for k, v in batch.items()})
    with FlopCounterMode(display=False) as fc:
        step()
    card = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert sum(card.get(k, 0) for k in ("aten.mm", "aten.bmm", "aten.addmm")) \
        == counted["gemm_flops"] > 0
    assert counted["flops_by_op"]["repro_torch.flash_attention"] > 0


def _step_loss_and_grads(model, cfg, batch, monkeypatch):
    """One ``make_train_step`` step (the arch's moments): its loss and its
    gradients on the host, by parameter name."""
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    seen, grads = {}, step_mod._grads

    def spy(params, loss):
        g = grads(params, loss)
        seen.update({n: t.detach().to("cpu", torch.float32) for n, t in g.items()})
        return g

    opt_cfg = adamw.AdamWConfig(lr=1e-3, moments_dtype=cfg.moments_dtype)
    ts = step_mod.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
    monkeypatch.setattr(step_mod, "_grads", spy)
    _, _, m = ts(model, adamw.init(model, opt_cfg), batch)
    monkeypatch.undo()
    return float(m["loss"]), seen


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_full_width_ssm_layer_train_step_on_card_matches_cpu(cuda, arch, monkeypatch):
    """One layer at its published widths (rwkv6-3b's: d 2,560, 48 padded wkv
    heads; jamba's Mamba + dense: d 8,192, d_inner 16,384), one train step
    on 1 x 256 tokens from one seeded init, card against a CPU copy: the
    loss within rtol 2e-4 and each gradient within 2e-3 * its max |g| on the
    CPU (chip_smoke.py's STEP_LOSS_RTOL / STEP_GRAD_RTOL)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import LayerSpec
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    over = dict(num_layers=1)
    if arch.startswith("jamba"):
        over["pattern"] = (LayerSpec("mamba", "dense"),)
    cfg = dataclasses.replace(get_arch(arch), **over)
    model = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg, TEST_POLICY, cuda)
    cpu_model = copy.deepcopy(model).to("cpu")
    host = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 0, 1, 256).items()}
    loss, grads = _step_loss_and_grads(model, cfg, {k: v.to(cuda) for k, v in host.items()},
                                       monkeypatch)
    del model
    torch.cuda.empty_cache()
    want_loss, want = _step_loss_and_grads(cpu_model, cfg, host, monkeypatch)
    assert abs(loss - want_loss) <= 2e-4 * abs(want_loss)
    assert set(grads) == set(want)
    for n, g in want.items():
        assert float((grads[n] - g).abs().max()) <= 2e-3 * float(g.abs().max()), n


#: Each example at its CI size on the card, and the kernels its path must
#: launch (chip_smoke.py's EXAMPLE_KERNELS).
EXAMPLES_ON_THE_CARD = [
    ("torch_quickstart", [], ("apnc_embed", "apnc_assign")),
    ("torch_stream_quickstart", [], ("fused_apnc_step",)),
    ("torch_covtype_scale", ["--smoke"], ("apnc_embed", "fused_dequant_step")),
    ("torch_activation_clustering", ["--smoke"], ("apnc_embed", "apnc_assign", "flash")),
    ("torch_train_lm", ["--steps", "20", "--d-model", "64", "--layers", "2", "--batch", "2",
                        "--seq", "64"], ("flash",)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,argv,kernels", EXAMPLES_ON_THE_CARD,
                         ids=[e[0] for e in EXAMPLES_ON_THE_CARD])
def test_example_on_the_card(cuda, tmp_path, name, argv, kernels):
    """The script's ``main`` on the card: what it prints holds (round trip,
    serving, a falling loss) and it launched the kernels its path names."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.kernels import lloyd_step

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def counts():
        return dict(apnc_embed=t_embed.launches, apnc_assign=t_assign.launches,
                    flash=t_flash.launches, **lloyd_step.launches)

    before = counts()
    if name == "torch_train_lm":
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    out = module.main(argv)
    launched = {k: v - before[k] for k, v in counts().items()}
    assert all(launched[k] > 0 for k in kernels), launched
    if "replay_identical" in out:
        assert out["replay_identical"] == out["served_match_fit"] == out["served"] == 200
    if "loss_first" in out:
        assert out["loss_last"] < out["loss_first"]


KMEANSPP_POOLS = [(1024, 256, 164), (1024, 256, 7), (2624, 256, 164), (7, 24, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("disc", ["l2", "l1"])
@pytest.mark.parametrize("nmk", KMEANSPP_POOLS, ids=lambda s: "x".join(map(str, s)))
def test_kmeanspp_seed_kernel_matches_plain(cuda, nmk, disc):
    """All k - 1 picks in one launch: the plain version's picks on the card and
    on the CPU from the same exponentials, centroids bit for bit the pool's
    rows; a pool of 2,624 rows (a distributed fit's 16 k sample) takes a
    cluster of 16."""
    from repro_torch.kernels import kmeanspp

    n, m, k = nmk
    g = torch.Generator().manual_seed(n + k)
    Y = torch.randn((n, m), generator=g)
    E = torch.empty((k - 1, n), dtype=torch.float64).exponential_(1, generator=g)
    assert kmeanspp.cluster_size(n, m) == (16 if n == 2624 else 8)
    picks, C, bad = kmeanspp.kmeanspp_seed(Y.to(cuda), E.to(cuda), 5 % n, disc)
    plain = ref.kmeanspp_seed_ref(Y.to(cuda), (E.to(cuda),), 5 % n, k, disc)
    host = ref.kmeanspp_seed_ref(Y, (E,), 5 % n, k, disc)
    assert torch.equal(picks, plain[0]) and torch.equal(picks.cpu(), host[0])
    assert torch.equal(C, plain[1]) and torch.equal(C.cpu(), Y[host[0]])
    assert not bool(bad) and not bool(plain[2])


@pytest.mark.gpu
def test_kmeanspp_pool_too_large_for_a_cluster_takes_the_plain_route(cuda):
    """8,192 x 256 floats hold no cluster's shared memory: the plain version
    on the card, no launch, the CPU's picks."""
    from repro_torch.core.lloyd import kmeanspp_init
    from repro_torch.kernels import kmeanspp

    Y = torch.randn((8192, 256), generator=torch.Generator().manual_seed(2))
    assert kmeanspp.cluster_size(8192, 256) == 0
    launched = kmeanspp.launches
    C = kmeanspp_init(torch.Generator().manual_seed(4), Y.to(cuda), 30, "l2")
    assert kmeanspp.launches == launched
    assert torch.equal(C.cpu(), kmeanspp_init(torch.Generator().manual_seed(4), Y, 30, "l2"))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["nystrom", "sd"])
def test_traced_fit_seeds_each_restart_in_one_launch(cuda, method):
    """A traced local fit on the card: one ``seed.draws`` span a restart
    (route ``kernel``, ``draws`` k - 1) holding one ``launch.kmeanspp_seed``,
    and the picks the CPU's plain route makes from the same pool."""
    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.core.lloyd import kmeanspp_init
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.kernels import kmeanspp

    k, restarts = 9, 3
    X = torch.from_numpy(gaussian_blobs_blocks(
        0, 6000, 32, k, block_rows=1024, separation=3.0)[0].materialize()).to(cuda)
    est = KernelKMeans(k, method=method, backend="local", l=128, m=64, iters=3,
                       n_init=restarts, kernel_params=dict(gamma=0.01), random_state=3)
    est.fit(X)  # builds the kernels outside the traced fit
    launched = kmeanspp.launches
    obs.clear_trace()
    obs.enable_tracing()
    try:
        est.fit(X)
        torch.cuda.synchronize()
    finally:
        obs.disable_tracing()
    spans = obs.TRACER.spans()
    obs.clear_trace()
    draws = [s for s in spans if s.name == "seed.draws"]
    launches = [s for s in spans if s.name == "launch.kmeanspp_seed"]
    assert [s.attrs for s in draws] == [{"draws": k - 1, "route": "kernel"}] * restarts
    assert len(launches) == restarts and kmeanspp.launches - launched == restarts
    for d, s in zip(draws, launches):
        assert d.t0 <= s.t0 and s.t0 + s.dur <= d.t0 + d.dur
    pool = torch.randn((1024, 64), generator=torch.Generator().manual_seed(1))
    disc = est.model_.params.discrepancy
    for r in range(restarts):
        card = kmeanspp_init(torch.Generator().manual_seed(r), pool.to(cuda), k, disc)
        assert torch.equal(card.cpu(), kmeanspp_init(torch.Generator().manual_seed(r), pool, k,
                                                     disc))

